"""Shared set-up of the benchmark's own tests.

    python -m pytest -q perfbench/tests

They run on the CPU at tiny sizes; a test marked ``card`` needs a CUDA
device and skips without one (decided inside the test, never at import).
"""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import boot  # noqa: E402,F401  (the program's src/ on sys.path too)
from harness import spec as specs  # noqa: E402

#: tiny widths for each family, applied to a cell's model, inputs and program fields
TINY = {
    "dense": ({"layers": 2, "d_model": 64, "heads": 4, "kv_heads": 2, "head_dim": 16, "d_ff": 128, "vocab": 256},
              {"vocab": 256},
              {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "d_ff": 128,
               "vocab": 256},
              {"batch": 2, "seq": 32}),
    "resnet_v2": ({"stages": [1, 1, 1, 1], "base_width": 8, "image_size": 32, "classes": 10},
                  {"size": 32, "classes": 10},
                  {"stages": [1, 1, 1, 1], "base_width": 8, "img_size": 32, "n_classes": 10},
                  {"batch": 8}),
}


#: program against reference at tiny widths on the CPU, where the program
#: computes in bf16 (granite) or in f32 with other convolution algorithms
#: (ResNet); the cells' own limits are set at their full sizes on the card
AGREE = {"dense": {"loss": 2e-3, "grad": 1e-2, "update": 1e-2},
         "resnet_v2": {"loss": 1e-4, "grad": 1e-2, "update": 2e-2}}


def tiny_spec(cell: str, **traffic) -> dict:
    """The cell's spec at tiny widths (its traffic updated by ``traffic``)."""
    s = specs.load(cell)
    c = s["config_data"]
    model, inputs, fields, t = TINY[c["model"]["family"]]
    c["model"].update(model)
    c["inputs"].update(inputs)
    c["program"]["fields"].update(fields)
    s["traffic_data"].update(t, **traffic)
    return s


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
