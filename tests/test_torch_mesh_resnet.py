"""The resnet family's sharded train steps (resnet_small reduced: the batch
over the data axes, each rank's convolutions on its own images, BatchNorm's
statistics over the whole batch) on a 2 x 4 (data, model) gloo mesh, eight
processes, against the port's single-device path (``torch_mesh_family.py``
runs them). ResNet has no serving path: its serve variants raise the
model's own error (``tests/test_torch_mesh.py``).

The step computes in f32, yet AdamW's first moment after step 1 reads
4.7e-3 (its worst leaf, a BatchNorm bias): the single-device step itself
moves by 4.6e-3 between one and eight CPU threads, since the CPU's
convolutions pick their algorithm by the thread count and the batch size.
"""
import pytest

from torch_mesh_family import check_train, run_family

ARCH = "resnet_small"


@pytest.fixture(scope="module")
def found(tmp_path_factory):
    return run_family(ARCH, None, tmp_path_factory.mktemp("resnet"))


@pytest.mark.parametrize("variant", ["baseline", "sp"])
def test_sharded_train_step_matches_single_device(found, variant):
    check_train(found["train"], variant)
