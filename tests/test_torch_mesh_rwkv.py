"""The rwkv family's sharded steps (rwkv6-1.6b reduced: the token shift,
lerps, data-dependent decay, WKV6 scan and ``ln_out`` on DTensors, heads
over ``model``) on a 2 x 4 (data, model) gloo mesh, eight processes, against
the port's single-device path (``torch_mesh_family.py`` runs them). The
prompt is three chunks long: ``wkv_chunked`` asserts that the chunk divides
the sequence, as the reference's does (the card's K5 masks a short last
chunk). The train steps run the plain ``wkv_chunked`` on DTensors; on the
card a sharded train step raises, since K5 has no backward (nor has the
reference's kernel).

The DTensor boundary of ``ops.wkv6``, which runs K5 on the card, on the
CPU: K5's plain version on each rank's batch rows and heads equals the
whole call, and so do the gradients of every input (the bonus's summed over
the ranks that split the batch).

Last, prefill and decode at batch 1, which the data axis cannot split (as
in the long_500k cells): the stream's d lies over the data axis, and the
decode step runs the channel mix's receptance product on each rank's
columns too.
"""
import pytest

from torch_mesh_family import VOCAB_SHARD, check_decode, check_local_shapes, check_prefill, check_train, run_family

ARCH = "rwkv6-1.6b"


@pytest.fixture(scope="module")
def found(tmp_path_factory):
    return run_family(ARCH, ARCH, tmp_path_factory.mktemp("rwkv"), extra=("wkv6", "batch1"))


@pytest.mark.parametrize("variant", ["baseline", "sp"])
def test_sharded_train_step_matches_single_device(found, variant):
    check_train(found["train"], variant)


@pytest.mark.parametrize("variant", ["baseline", "serve"])
def test_sharded_prefill_matches_single_device(found, variant):
    check_prefill(found["serve"], variant)


@pytest.mark.parametrize("variant", ["baseline", "serve"])
def test_sharded_decode_matches_single_device(found, variant):
    check_decode(found["serve"], variant)


def test_wkv6_on_local_shards_equals_the_whole_call(found):
    r = found["wkv6"]
    # f32 on both sides, the same token-by-token recurrence on each head
    assert r["out_err"] < 1e-5 and r["state_err"] < 1e-5, r
    # the scan's layout: batch over data, heads over model (out is (B, T, H, V), the state (B, H, K, V))
    assert r["out_placements"] == [0, 2] and r["state_placements"] == [0, 1], r


def test_wkv6_gradients_on_local_shards_equal_the_whole_calls(found):
    # r, k, v, logw, the bonus u and the initial state, relative to each one's largest element
    assert max(found["wkv6"]["grad_err"]) < 1e-5, found["wkv6"]


@pytest.mark.parametrize("variant", ["baseline", "sp"])
def test_sharded_train_step_runs_each_ranks_part(found, variant):
    check_local_shapes(found["train"][variant], flash=[], vocab=[VOCAB_SHARD], table=[VOCAB_SHARD])


@pytest.mark.parametrize("variant", ["baseline", "serve"])
def test_sharded_serving_runs_each_ranks_part(found, variant):
    # attention-free: the lookup and the loss alone meet the vocab's shards
    check_local_shapes(found["serve"]["prefill_" + variant], flash=[], table=[VOCAB_SHARD])
    check_local_shapes(found["serve"]["decode_" + variant], decode=[], table=[VOCAB_SHARD])


@pytest.mark.parametrize("run", ["train/baseline", "train/sp", "serve/prefill_baseline", "serve/prefill_serve",
                                 "serve/decode_baseline", "serve/decode_serve"])
def test_time_mix_runs_on_each_ranks_heads(found, run):
    # r, k, v and g on the columns of the rank's 2 of the 8 heads: 16 of 64
    case, name = run.split("/")
    check_local_shapes(found[case][name], proj=[16])


def test_batch1_prefill_matches_single_device(found):
    check_prefill(found["batch1"], "baseline")


def test_batch1_decode_matches_single_device(found):
    check_decode(found["batch1"], "baseline")
    # the time mix's r, k, v, g and the channel mix's r on the columns of the rank's 2 of the 8 heads
    check_local_shapes(found["batch1"]["decode_baseline"], proj=[16], table=[VOCAB_SHARD])
