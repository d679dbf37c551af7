"""Time this tree's K1 (``flex_fwd_cse``) beside another tree's on the card.

    python3 tools/k1_compare.py --other build/parent   # from the repo root

``--other`` is a checkout of another revision (a parent commit unpacked with
``git archive`` into a directory ``.gitignore`` lists); its
``csat_tpu_torch/ops/csrc`` source that holds ``flex_fwd_cse`` is compiled
with this tree's ``nvcc`` flags and bound through the same C signature.  Both
kernels run on the inputs of ``chip_smoke.py``'s phase 3 — every serving
batch and bucket shape with random masks, the train batch's real distances
and masks, and the serve phase's largest prefill group — and are held
against the plain path; times are ``chip_smoke.cuda_ms`` in turns (other,
this, this, other), averaged.  Prints one JSON line per input and the card's
``nvidia-smi`` name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from csat_tpu_torch.ops import build, flex_core  # noqa: E402

SHAPES = ((4, 150), (64, 150), (1, 37), (4, 37), (8, 37), (1, 75), (4, 75), (8, 75), (1, 150),
          (128, 75), (259, 37))


def other_kernel(tree: Path):
    """``flex_fwd_cse`` compiled from ``tree``'s sources."""
    srcs = [p for p in sorted((tree / "csat_tpu_torch/ops/csrc").glob("*.cu"))
            if "flex_fwd_cse" in p.read_text()]
    if len(srcs) != 1:
        raise SystemExit(f"no single source of flex_fwd_cse under {tree}: {srcs}")
    so = REPO / "build" / "k1_other.so"
    so.parent.mkdir(exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(srcs[0])], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(so)).flex_fwd_cse
    fn.argtypes, fn.restype = build._ARGTYPES["flex_fwd_cse"], ctypes.c_int
    return fn, str(srcs[0].relative_to(tree))


def inputs(dev):
    from csat_tpu_torch.configs import get_config

    gen = torch.Generator().manual_seed(cs.SEED)
    for b, n in SHAPES:
        yield f"random {b}x{n}", cs._flex_inputs("cse", b, n, gen, dev)
    cfg = get_config("python", noise_mode="counter")
    batch = cs.train_batch(cfg, cs.TRAIN_B)
    rel_mask = (torch.stack([batch.L, batch.T], dim=1).to(torch.int32).contiguous(),
                torch.stack([batch.L_mask, batch.T_mask], dim=1).contiguous())
    yield "train batch", cs._flex_inputs("cse", cs.TRAIN_B, 150, gen, dev, rel_mask=rel_mask)
    serve_cfg = cs.flagship()
    cap = cs.capture_cse_inputs(serve_cfg, *cs.make_requests(serve_cfg))
    yield cap["inputs"], tuple(cap[key] for key in ("q", "k", "v", "spec", "aux"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True, help="the other tree's root")
    args = ap.parse_args(argv)
    smi = cs.device_phase()
    build.build_all(["flex_fwd_tc"])
    other, other_src = other_kernel(args.other.resolve())
    kernels = {"other": other, "this": build.kernel("flex_fwd_cse")}
    dev = torch.device("cuda")
    for name, (q, k, v, spec, aux) in inputs(dev):
        with torch.no_grad():
            ref, rex = flex_core.flex_reference(q, k, v, spec, aux)
        _, args_c, outs = flex_core.kernel_args(spec, q, k, v, aux)
        skips = flex_core.reference_block_skip(spec, aux, flex_core.geometry(q))
        rec = {"inputs": name, "B": q.shape[0], "N": q.shape[2], "other_source": other_src,
               "live_entries": int((~aux[3]).sum()) * spec.group}
        for key, fn in kernels.items():
            rc = fn(*args_c)
            torch.cuda.synchronize()
            ok = (rc == 0 and torch.equal(outs["skip"].sum(2).float(), skips)
                  and torch.equal(outs["gsum"].sum(2), rex["graph_sum"]))
            rec[key] = dict(max_abs_err=(outs["out"] - ref).abs().max().item(),
                            lse_max_abs_err=(outs["lse"] - rex["lse"]).abs().max().item(),
                            skip_and_gsum_exact=ok)
        times = {key: [] for key in kernels}
        for key in ("other", "this", "this", "other"):
            times[key].append(cs.cuda_ms(lambda: kernels[key](*args_c)))
        for key in kernels:
            rec[key]["ms"] = sum(times[key]) / len(times[key])
        rec["ratio"] = rec["this"]["ms"] / rec["other"]["ms"]
        print(json.dumps(rec), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
