"""The hybrid family's sharded steps (zamba2-7b reduced: the mamba2 blocks'
in-projection, causal conv and chunked SSD scan on DTensors, heads over
``model``, and the shared attention block with its K/V cache) on a 2 x 4
(data, model) gloo mesh, eight processes, against the port's single-device
path (``torch_mesh_family.py`` runs them). The prompt is three chunks long:
``ssd_chunked`` asserts that the chunk divides the sequence, as the
reference's does.

AdamW's first moment after the first step is held to a limit of its own.
Its worst leaf is ``A_log`` (the SSM's decay rates), whose gradient is a
sum of many terms that nearly cancel (norm 1.2e-4, against 0.05 to 1.4 for
the other leaves), so bf16's rounding moves it the most. Read: 0.0368
(baseline) and 0.0414 (sp) at 2 x 4; ``A_log`` 0.044 at 1 x 4, below 3.2e-3
at 2 x 1 (the data axis alone rounds nothing in bf16); the single-device
step itself moves ``A_log``'s gradient by 0.044 when one bf16 ulp of noise is
put on two thirds of the embedding table. Every other leaf reads 0.017 to
0.019 at 2 x 4. Planted fault, ``dist.local_operand`` leaving out the sum
over the ranks that split the batch (``A_log``'s gradient each data rank's
own examples'): 0.905 and 0.892.

The prefill's logits read 0.043 of the common 6e-2 (bf16's partial sums
over the model axis; 0.057 when the residual stream carried them unreduced;
the decode's 0.041, the states 0.011 of 3e-2).

Last, the decode attention at batch 1 over a cache that every mesh dim
replicates (the shared block's cache in the long-context cells): the data
axis, which then holds nothing to split, splits each rank's cache rows.
"""
import pytest

from torch_mesh_family import (ONE_HEAD, VOCAB_SHARD, check_decode, check_local_shapes, check_prefill, check_train,
                               run_family)

ARCH = "zamba2-7b"
#: AdamW's first moment after step 1 (relative L2, worst leaf); see above
ZAMBA_STEP1_MOMENT_RTOL = 6e-2


@pytest.fixture(scope="module")
def found(tmp_path_factory):
    return run_family(ARCH, ARCH, tmp_path_factory.mktemp("hybrid"), extra=("decode_idle",))


@pytest.mark.parametrize("variant", ["baseline", "sp"])
def test_sharded_train_step_matches_single_device(found, variant):
    check_train(found["train"], variant, moment_rtol=ZAMBA_STEP1_MOMENT_RTOL)


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
    # the shared block's caches (25 rows: 24 prompt tokens and the new one) do not divide
    # ``model``: replicated, so each rank takes its query head and the KV head it reads
    check_local_shapes(found["serve"]["prefill_" + variant], flash=[ONE_HEAD], table=[VOCAB_SHARD])
    check_local_shapes(found["serve"]["decode_" + variant], decode=[[1, 1, 25, False]], table=[VOCAB_SHARD])


def test_decode_at_batch_one_splits_the_cache_rows_over_the_data_axis(found):
    r = found["decode_idle"]
    # flash-decode's merge of two row halves against the whole call: one bf16 rounding
    assert max(r["errs"]) < 2e-2, r
    # a rank's 2 query heads and their 2 KV heads over its 12 of the 24 rows, with the lse
    check_local_shapes(r, decode=[[2, 2, 12, True]])
