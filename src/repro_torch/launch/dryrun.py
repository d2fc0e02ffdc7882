"""Multi-pod dry-run: lower every (arch x shape x mesh) cell on a host
(PyTorch twin of ``repro.launch.dryrun``).

The reference lowers and compiles each cell on 512 placeholder host devices.
The port lowers each on a fake process group of the mesh's world (256 ranks
for ``single``, 512 for ``multi``), started by ``lowering.fake_world`` for
the cell and destroyed after it, over a ``DeviceMesh`` of ``cpu`` devices:
the real step function (``jit_train_step`` for train shapes,
``jit_prefill_step``/``jit_decode_step`` for serving shapes) traced once, as
rank 0, on fake tensors in the full shardings (``lowering.lower_cell``).
Nothing executes and no card is touched. Each record holds:

  * ``memory_analysis``: a device's argument, output, alias and temporary
    bytes (the storages the traced call holds live, ``OpLog``) and their
    peak, under the reference's names. Off the card every kernel wrapper
    takes its plain version (as the reference's ``ops`` take their ``ref``
    path off the TPU), so the temporaries are the plain path's: its
    attention materializes the score matrix, which the card's kernels never
    hold;
  * the roofline report (``telemetry/roofline.py``, the H100's constants)
    over per-device FLOPs and HBM bytes by the reference's traffic model
    (``telemetry/hlo.py``) and the collectives' wire bytes, each collective
    priced over its own process group;
  * the DCGM analogues of that report.

Two of the reference's keys have no counterpart and are written as null:
``xla_cost_analysis`` (there is no compiler, so no compiler's own cost
count) and ``t_compile_s`` (the traced call is the whole lowering, timed as
``t_lower_s``).

Artifacts land in artifacts/dryrun/<arch>__<shape>__<mesh>[__tag].json, the
reference's names and keys, so ``python -m benchmarks.report dryrun`` renders
them.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--tag baseline]
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

from repro_torch.configs.base import SHAPES_BY_NAME, shape_applicable
from repro_torch.configs.registry import ASSIGNED, get_config
from repro_torch.launch.lowering import active_params, fake_world, lower_cell
from repro_torch.launch.mesh import make_mesh_shape, mesh_chips, mesh_label
from repro_torch.telemetry import constants as C
from repro_torch.telemetry import roofline as rl


def _mesh_dims(mesh_kind: str, mesh_spec: str):
    """(dims, axis names) of the cell's mesh: the production mesh of
    ``mesh_kind`` or the logical reshape ``mesh_spec`` (e.g. 64x4)."""
    if mesh_spec:
        dims = tuple(int(x) for x in mesh_spec.split("x"))
        return dims, ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    if mesh_kind == "multi":
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: Path, tag: str = "",
             grad_accum: int = 1, variant: str = "baseline",
             remat: bool | None = None, mesh_spec: str = "") -> dict:
    suite = SHAPES_BY_NAME[shape]
    cfg = get_config(arch)
    ok, why = shape_applicable(cfg, suite)
    label = f"{arch}__{shape}__{mesh_kind}" + (f"__{tag}" if tag else "")
    if not ok:
        rec = {"cell": label, "status": "SKIP", "reason": why}
        (out_dir / f"{label}.json").write_text(json.dumps(rec, indent=2))
        return rec

    t0 = time.time()
    dims, names = _mesh_dims(mesh_kind, mesh_spec)
    with fake_world(math.prod(dims)):
        mesh = make_mesh_shape(dims, names, device="cpu")
        cfg, model, lowered = lower_cell(arch, suite, mesh, grad_accum=grad_accum,
                                         variant=variant, remat=remat)
        chips, label_mesh = mesh_chips(mesh), mesh_label(mesh)
    t_lower = time.time() - t0

    n_total = model.param_count()
    n_active = active_params(cfg, n_total)
    mem = lowered.memory
    coll = lowered.collectives
    report = rl.RooflineReport(
        arch=arch,
        shape=shape,
        mesh=label_mesh,
        chips=chips,
        flops_per_device=float(lowered.flops),
        hbm_bytes_per_device=float(lowered.bytes),
        wire_bytes_per_device=float(coll["per_device_wire_bytes"]),
        model_flops_global=rl.model_flops(cfg, suite, n_active),
        peak_mem_bytes_per_device=float(mem["peak_bytes_per_device"]),
        collective_detail={k: coll[k] for k in ("by_kind", "top_ops", "n_collective_sites")},
        peak_flops=C.PEAK_FLOPS[lowered.product_dtype],
    )
    rec = {
        "cell": label,
        "status": "OK",
        "grad_accum": grad_accum,
        "variant": variant,
        "t_lower_s": round(t_lower, 1),
        "t_compile_s": None,
        "n_params_total": n_total,
        "n_params_active": n_active,
        "xla_cost_analysis": None,
        "memory_analysis": dict(mem),
        "fingerprint": lowered.fingerprint,
        "dcgm_analogues": rl.dcgm_analogues(report),
        "roofline": report.to_dict(),
    }
    (out_dir / f"{label}.json").write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ASSIGNED), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES_BY_NAME), default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--variant", default="baseline",
                    choices=("baseline", "sp", "zero", "serve"))
    ap.add_argument("--remat", default="default", choices=("default", "on", "off"))
    ap.add_argument("--mesh-spec", default="",
                    help="logical reshape of the pod, e.g. 64x4 (data x model);"
                         " same 256 chips, different axis split (perf variant)")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)

    cells = []
    if args.all:
        for arch in ASSIGNED:
            for shape in SHAPES_BY_NAME:
                for mk in meshes:
                    cells.append((arch, shape, mk))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all) required")
        for mk in meshes:
            cells.append((args.arch, args.shape, mk))

    failures = 0
    remat = {"default": None, "on": True, "off": False}[args.remat]
    for arch, shape, mk in cells:
        try:
            rec = run_cell(arch, shape, mk, out_dir, args.tag, args.grad_accum,
                           args.variant, remat, args.mesh_spec)
            if rec["status"] == "OK":
                r = rec["roofline"]
                print(
                    f"[OK]   {rec['cell']}: compute={r['compute_s']:.4f}s "
                    f"memory={r['memory_s']:.4f}s coll={r['collective_s']:.4f}s "
                    f"bound={r['bound']} mem/dev={r['peak_mem_bytes_per_device']/2**30:.2f}GiB "
                    f"(lower {rec['t_lower_s']}s)",
                    flush=True,
                )
            else:
                print(f"[SKIP] {rec['cell']}: {rec['reason']}", flush=True)
        except Exception as e:  # noqa: BLE001 — record and continue the sweep
            failures += 1
            label = f"{arch}__{shape}__{mk}"
            (out_dir / f"{label}.json").write_text(
                json.dumps({"cell": label, "status": "FAIL", "error": str(e)[:2000],
                            "traceback": traceback.format_exc()[-4000:]}, indent=2)
            )
            print(f"[FAIL] {label}: {e}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
