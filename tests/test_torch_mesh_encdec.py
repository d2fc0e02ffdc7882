"""The encdec family's sharded steps (whisper-base reduced: the frames,
heads, self and cross caches and decode activations under DTensors) on a
2 x 4 (data, model) gloo mesh, eight processes, against the port's
single-device path (``torch_mesh_family.py`` runs them)."""
import pytest

from torch_mesh_family import (ONE_HEAD, SEQ_SHARD_DECODE, VOCAB_SHARD, check_decode, check_local_shapes,
                               check_prefill, check_train, run_family)

ARCH = "whisper-base"


@pytest.fixture(scope="module")
def found(tmp_path_factory):
    return run_family(ARCH, ARCH, tmp_path_factory.mktemp("encdec"))


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
