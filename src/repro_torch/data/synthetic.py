"""Deterministic synthetic datasets, shape-faithful to the paper's workloads.

The paper trains on CIFAR-10 / ImageNet64x64 / ImageNet2012; no dataset is
bundled, so each is replaced by a seeded generator producing batches
of identical shape, dtype, cardinality and (approximate) statistics. The
determinism contract — ``batch(epoch, step)`` is a pure function of
(seed, epoch, step) — is what checkpoint-resume and the elastic repack rely
on: a job restarted on a different instance replays the exact same stream.

LM token streams serve the assigned-architecture training examples the same
way.

Numpy only, and a copy of ``repro.data.synthetic``: the same
``(seed, epoch, step)`` gives the same bytes in both packages, so both
frameworks see the same batches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np



@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Cardinality + shape metadata for one synthetic dataset."""

    name: str
    n_train: int
    n_val: int
    image_size: int = 0  # images: H=W
    n_classes: int = 0
    vocab: int = 0  # LM streams
    seq_len: int = 0


# the paper's datasets (§3.3.1)
CIFAR10 = DatasetSpec("cifar10", 45_000, 5_000, image_size=32, n_classes=10)
IMAGENET64 = DatasetSpec("imagenet64", 1_281_167, 50_000, image_size=64, n_classes=1000)
IMAGENET224 = DatasetSpec("imagenet224", 1_281_167, 50_000, image_size=224, n_classes=1000)

DATASETS = {d.name: d for d in (CIFAR10, IMAGENET64, IMAGENET224)}

FOR_WORKLOAD = {
    "resnet_small": CIFAR10,
    "resnet_medium": IMAGENET64,
    "resnet_large": IMAGENET224,
}


def _rng(seed: int, epoch: int, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, epoch, step])
    )


def _astype(a: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == "bfloat16":
        import ml_dtypes  # numpy has no bfloat16 of its own

        return a.astype(ml_dtypes.bfloat16)
    return a.astype(dtype)


def image_batch(
    spec: DatasetSpec, batch: int, *, seed: int = 0, epoch: int = 0, step: int = 0
) -> Dict[str, np.ndarray]:
    """One (images, labels) batch: N(0,1) pixels (mean-subtracted, like the
    paper's preprocessing), uniform labels."""
    g = _rng(seed, epoch, step)
    s = spec.image_size
    return {
        "images": g.standard_normal((batch, s, s, 3), dtype=np.float32),
        "labels": g.integers(0, spec.n_classes, (batch,), dtype=np.int32),
    }


def token_batch(
    vocab: int, batch: int, seq_len: int, *, seed: int = 0, epoch: int = 0,
    step: int = 0, extras: Optional[Dict[str, Tuple[Tuple[int, ...], str]]] = None,
) -> Dict[str, np.ndarray]:
    """LM (tokens, labels) batch; labels are tokens shifted by one (next-token
    prediction over a deterministic pseudo-corpus)."""
    g = _rng(seed, epoch, step)
    stream = g.integers(0, vocab, (batch, seq_len + 1), dtype=np.int32)
    out = {"tokens": stream[:, :-1], "labels": stream[:, 1:]}
    for name, (shape, dtype) in (extras or {}).items():
        out[name] = _astype(g.standard_normal(shape, dtype=np.float32), dtype)
    return out


def batch_for(model_cfg, suite, *, seed: int = 0, epoch: int = 0, step: int = 0):
    """Shape-correct batch for any (config, suite) — mirrors input_specs."""
    if model_cfg.family == "resnet":
        spec = FOR_WORKLOAD.get(
            model_cfg.name,
            DatasetSpec("custom", 45_000, 5_000, model_cfg.img_size, model_cfg.n_classes),
        )
        return image_batch(spec, suite.global_batch, seed=seed, epoch=epoch, step=step)
    extras = {}
    B = suite.global_batch
    if model_cfg.n_patches:
        extras["patches"] = ((B, model_cfg.n_patches, model_cfg.d_model), "bfloat16")
    if model_cfg.enc_layers:
        extras["frames"] = ((B, model_cfg.n_frames, model_cfg.d_model), "bfloat16")
    return token_batch(
        model_cfg.vocab, B, suite.seq_len,
        seed=seed, epoch=epoch, step=step, extras=extras,
    )


def steps_per_epoch(spec: DatasetSpec, batch: int) -> int:
    return -(-spec.n_train // batch)


def epoch_iterator(
    spec: DatasetSpec, model_cfg, suite, *, seed: int = 0, epoch: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    for step in range(steps_per_epoch(spec, suite.global_batch)):
        yield batch_for(model_cfg, suite, seed=seed, epoch=epoch, step=step)
