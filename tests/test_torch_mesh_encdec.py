"""The encdec family's sharded steps (whisper-base reduced: the frames,
heads, self and cross caches and decode activations under DTensors) on a
2 x 4 (data, model) gloo mesh, eight processes, against the port's
single-device path (``torch_mesh_family.py`` runs them); and with 6 heads
and 6 frames, which ``model`` does not divide, each rank's ``row_split``
share: 3 heads on half the query rows (a zig-zag of them in the causal self
attention), the outputs brought to ``wo``'s row layout by an all-to-all over
``model``, and at decode half the cross cache's frames, merged over
``model``."""
import pytest

from torch_mesh_family import (ONE_HEAD, SEQ_SHARD_DECODE, VOCAB_SHARD, check_decode, check_local_shapes,
                               check_prefill, check_train, run_family)

ARCH = "whisper-base"


@pytest.fixture(scope="module")
def found(tmp_path_factory):
    return run_family(ARCH, ARCH, tmp_path_factory.mktemp("encdec"), extra=("row_split",))


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
    # the cross caches (8 frames) are sharded on their sequence too: 2 rows a rank
    check_local_shapes(found["serve"]["prefill_" + variant], flash=[ONE_HEAD], table=[VOCAB_SHARD])
    check_local_shapes(found["serve"]["decode_" + variant], decode=[[4, 2, 2, True], SEQ_SHARD_DECODE], table=[VOCAB_SHARD])


def test_row_split_steps_match_single_device(found):
    """6 heads at ``model`` 4: the train step, prefill and decode on each
    rank's share against the single device, at the file's limits."""
    r = found["row_split"]
    check_train(r["train"], "baseline")
    check_prefill(r["serve"], "baseline")
    check_decode(r["serve"], "baseline")
    # rank 0: its group's 3 heads (G 1) on its part of the rows: the first
    # half where the attention is not causal (3 of 6 frames, 16 of the 32
    # decoder rows and 15 of the prompt's 31 in the cross attention); the
    # first and last of 4 slices in the decoder's causal self attention (8 +
    # 8 of 32 rows, 7 + 8 of 31), a call each
    check_local_shapes(r["train"]["baseline"], flash=[[3, 1]], rows=[[3, 0], [8, 0], [8, 24], [16, 0]])
    check_local_shapes(r["serve"]["prefill_baseline"], flash=[[3, 1]], rows=[[3, 0], [7, 0], [8, 23], [15, 0]])
    # self attention over the rank's 8 of 32 cache rows, all heads; cross
    # attention with its 3 heads over 3 of the 6 frames
    check_local_shapes(r["serve"]["decode_baseline"], decode=[[3, 3, 3, True], [6, 6, 8, True]])
