"""The check fails what it has to fail, at a tiny size on the CPU: the
control (the reference computed in the precision below the configuration's,
put in the program's place) reads past the cell's limits and well past the
program, and runs of the harness with the program's training step broken
underneath (a step that leaves the state unchanged, a step that trains on
half of each batch) come out not correct, where the unbroken run agrees
with the reference."""
import pytest

from conftest import AGREE, tiny_spec
from harness import cell, check
from harness.job import Job
from reference import train as ref

CELLS = ["granite-train-32k", "granite-train-4k", "resnet50-naive-x7"]


def _tiny(name):
    # the 32k cell's traffic keeps its micro batch of 1 at the tiny size
    return tiny_spec(name, jobs=1, **({"batch": 1} if name == "granite-train-32k" else {}))


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    spec = _tiny(name)
    job = Job(spec, 5, "cpu")
    readout = job.setup()
    job.free()
    n, low = spec["traffic_data"]["checked_steps"], spec["config_data"]["precision"]["control"]
    base = ref.follow(spec, 5, job.layout, n, "cpu")
    program = check.numbers(readout, base, spec.get("loss_steps"))
    control = check.numbers(ref.follow(spec, 5, job.layout, n, "cpu", low), base, spec.get("loss_steps"))
    assert not check.verdict(control, spec["limits"]), control
    assert any(control[k] >= 3 * program[k] for k in check.NUMBERS), (program, control)


def _half_batch(monkeypatch):
    from repro_torch.runtime import train_step as ts

    real = ts.build_train_step

    def build(*a, **kw):
        step = real(*a, **kw)
        return lambda state, batch: step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

    monkeypatch.setattr(ts, "build_train_step", build)


def _unchanged(monkeypatch):
    from repro_torch.optim import adamw

    monkeypatch.setattr(adamw, "apply_updates", lambda params, grads, state, cfg: (params, state, {}))


#: every fault a cell can have: a batch of one row has no half to leave out
CASES = [(name, fault) for name in CELLS for fault in ("none", "state_unchanged", "half_batch")
         if not (fault == "half_batch" and name == "granite-train-32k")]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_broken_step_is_not_correct(monkeypatch, name, fault):
    spec = _tiny(name)
    if fault == "state_unchanged":
        _unchanged(monkeypatch)
    elif fault == "half_batch":
        _half_batch(monkeypatch)
    nums = cell.run(spec, 9, 0.2, False, "cpu")["numbers"]
    agree = AGREE[spec["config_data"]["model"]["family"]]
    if fault == "none":
        assert check.verdict(nums, agree), nums
    else:
        assert not check.verdict(nums, spec["limits"]) and not check.verdict(nums, agree), nums
