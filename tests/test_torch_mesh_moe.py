"""The moe family's sharded steps on a 2 x 4 (data, model) gloo mesh, eight
processes, against the port's single-device path (``torch_mesh_family.py``
runs them): olmoe-1b-7b reduced trains, deepseek-moe-16b reduced serves, the
grouped expert-parallel dispatch, capacity sort, combine and aux loss under
DTensors. The sharded runs route by the single-device run's choices.

deepseek-moe-16b at the reference's init amplifies rounding (ROADMAP.md,
Queue 3: it is held to its own limits on the card too). Its sharded prefill
differs from the single device's by bf16's partial sums over the model axis
alone: on a 1 x 4 mesh 0.082 at worst, with 5 of its 2,048 logits (0.24%)
beyond 6e-2 and a relative L2 error of 1.5% (0.0 on 1 x 1 and 2 x 1). So its
prefill is held to 6e-2 for all but 0.5% of the logits and to 0.25 for every
one; its decode, the caches and the train steps to the common limits. With
each row-parallel product's partial sums reduced before they join the
residual stream, the 2 x 4 prefill reads 0.043, no logit beyond 6e-2 (0.082
and 0.24% when the stream carried them), the decode 0.051 (baseline) and
0.055 (serve).
"""
import pytest

from torch_mesh_family import (ONE_HEAD, SEQ_SHARD_DECODE, VOCAB_SHARD, check_decode, check_local_shapes,
                               check_prefill, check_train, run_family)

#: the share of deepseek's prefill logits allowed beyond 6e-2 (read: 0.24%)
DEEPSEEK_PREFILL_OUTLIERS = 5e-3


@pytest.fixture(scope="module")
def found(tmp_path_factory):
    return run_family("olmoe-1b-7b", "deepseek-moe-16b", tmp_path_factory.mktemp("moe"))


@pytest.mark.parametrize("variant", ["baseline", "sp"])
def test_sharded_train_step_matches_single_device(found, variant):
    check_train(found["train"], variant)


@pytest.mark.parametrize("variant", ["baseline", "serve"])
def test_sharded_prefill_matches_single_device(found, variant):
    check_prefill(found["serve"], variant, outliers=DEEPSEEK_PREFILL_OUTLIERS)


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
