"""The vlm family's sharded steps (llava-next-34b reduced: the patch splice
under DTensors) on a 2 x 4 (data, model) gloo mesh, eight processes, against
the port's single-device path (``torch_mesh_family.py`` runs them); and
with 14 query heads over 2 KV heads (G 7), which ``model`` does not divide,
each rank's ``row_split`` share: 7 heads and their KV head on a zig-zag
of half the causal query rows, q, k and v brought from the projections'
column blocks and the outputs to ``wo``'s row layout by all-to-alls over
``model``; and that boundary alone against the whole tensors, at a sequence
that ``model`` divides (the prefill cache's exchange to its rows)."""
import pytest

from torch_mesh_family import (BOUNDARY_HEADS, ONE_HEAD, SEQ_SHARD_DECODE, TOL_BOUNDARY_GRAD, VOCAB_SHARD,
                               check_decode, check_local_shapes, check_prefill, check_train, run_family)

ARCH = "llava-next-34b"


@pytest.fixture(scope="module")
def found(tmp_path_factory):
    return run_family(ARCH, ARCH, tmp_path_factory.mktemp("vlm"), extra=("row_split", "row_share_boundary"))


@pytest.mark.parametrize("variant", ["baseline", "sp"])
def test_sharded_train_step_matches_single_device(found, variant):
    check_train(found["train"], variant)


@pytest.mark.parametrize("variant", ["baseline", "serve"])
def test_sharded_prefill_matches_single_device(found, variant):
    check_prefill(found["serve"], variant)


@pytest.mark.parametrize("variant", ["baseline", "serve"])
def test_sharded_decode_matches_single_device(found, variant):
    check_decode(found["serve"], variant)


@pytest.mark.parametrize("variant", ["baseline", "sp"])
def test_sharded_train_step_runs_each_ranks_part(found, variant):
    check_local_shapes(found["train"][variant], flash=[ONE_HEAD], vocab=[VOCAB_SHARD], table=[VOCAB_SHARD])


@pytest.mark.parametrize("variant", ["baseline", "serve"])
def test_sharded_serving_runs_each_ranks_part(found, variant):
    check_local_shapes(found["serve"]["prefill_" + variant], flash=[ONE_HEAD], table=[VOCAB_SHARD])
    check_local_shapes(found["serve"]["decode_" + variant], decode=[SEQ_SHARD_DECODE], table=[VOCAB_SHARD])


def test_row_split_steps_match_single_device(found):
    """14 heads (G 7) at ``model`` 4: the train step, prefill and decode on
    each rank's share against the single device, at the file's limits."""
    r = found["row_split"]
    check_train(r["train"], "baseline")
    check_prefill(r["serve"], "baseline")
    check_decode(r["serve"], "baseline")
    # rank 0: one KV head and its 7 query heads on the first and last of 4
    # slices of the causal rows (8 + 8 of 32, 7 + 8 of 31), a call each
    check_local_shapes(r["train"]["baseline"], flash=[[1, 7]], rows=[[8, 0], [8, 24]])
    check_local_shapes(r["serve"]["prefill_baseline"], flash=[[1, 7]], rows=[[7, 0], [8, 23]])
    # decode: the rank's 8 of 32 rows of the sequence-sharded cache, all heads
    check_local_shapes(r["serve"]["decode_baseline"], decode=[[14, 2, 8, True]])


@pytest.mark.parametrize("heads", [f"{h}/{kv}" for h, kv in BOUNDARY_HEADS])
def test_row_share_boundary_matches_the_whole_tensors(found, heads):
    """q, k, v from their column blocks to each rank's row share and back
    (``attention.heads``, ``attend``), RoPE on the shares, at 32 rows:
    the output and dq the whole call's bits, dk and dv within
    ``TOL_BOUNDARY_GRAD``; ``write_cache``'s rows the whole RoPE'd K's and
    V's bits, by the exchange to cache rows over ``model`` (an all-to-all
    and no other collective) and by the gather into caches whole there."""
    r = found["row_share_boundary"][heads]
    assert r["share"] == "RowShareInputs", r
    assert r["out"] == 0.0 and r["grads"][0] == 0.0, r
    assert max(r["grads"]) < TOL_BOUNDARY_GRAD, r
    assert r["rows"] == [True, True] and r["whole"] == [True, True], r
    assert r["rows_route"] == ["all-to-all"] and r["whole_route"] == ["all-gather"], r
