"""Builds of the packed blend kernels (B4, B5 and their bf16 variants) held
against each other on one card.

    python -m lvdgs_torch.tools.packed_ab --source NAME=DIR [--source NAME=DIR ...]
        [--out FILE]

Each DIR holds a ``blend_packed.cu`` with the headers it includes: this
tree's ``lvdgs_torch/csrc``, a parent commit's unpacked with ``git
archive``, or a copy with one change to measure. Each is built with the
shipped flags into its own library; nvcc's ``-Xptxas -v`` lines are printed
with each kernel's registers, local (spill) bytes, static shared memory and
most resident blocks per SM (``lvdgs_packed_attrs``). On each block (the
random street-shaped block packed at NB 348, 464 and 928,
``lvdgs_torch.tools.blocks``) every kernel of every build runs on the same
inputs: B4 with touch counts, without and as the probe, B4-bf16 with and
without counts, B5 and B5-bf16 on the first build's forward outputs and one
random cotangent. Each output is compared bit for bit with the first
build's, each march length with the plain forward's, B5 is launched twice
to show that it repeats, and each kernel is timed straight from its library
(median of 10 CUDA-event timings of 20 back-to-back launches) in turns: the
builds in order, then in reverse. Needs a CUDA card and nvcc.

To hold whole street runs of two checkouts against each other, use
``chip_smoke.py --deterministic-street``.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import rasterizer_cuda as rc
from .blocks import street_packed_blocks
from .timing import card_line, time_ms

ROOT = Path(__file__).resolve().parents[2]
_BUILD = ROOT / "lvdgs_torch" / "_build" / "ab"
# the kernels compared, as lvdgs_packed_attrs names them: B4 and B4-bf16
# without touch counts, as tracking and mapping launch them
KERNELS = {"B4": "packed_fwd_kernel<false, NT_NONE>", "B4-bf16": "packed_fwd_kernel<true, NT_NONE>",
           "B5": "packed_bwd_kernel<false>", "B5-bf16": "packed_bwd_kernel<true>"}


class Build:
    """One build of blend_packed.cu, loaded with ctypes."""

    def __init__(self, name: str, src_dir: Path):
        self.name = name
        self.src = (src_dir / "blend_packed.cu").resolve()
        flags = [*rc._NVCC_FLAGS, "-fmad=false"]  # the shipped build's, with -Xptxas -v
        h = hashlib.sha256(" ".join(flags).encode())
        for f in sorted(src_dir.iterdir()):
            if f.suffix in (".cu", ".cuh"):
                h.update(f.name.encode() + f.read_bytes())
        out = _BUILD / f"{name}-{h.hexdigest()[:12]}"
        out.mkdir(parents=True, exist_ok=True)
        self.path = out / "libpacked.so"
        self.cmd = [rc._nvcc(), *flags, "-o", str(self.path), str(self.src)]

    def start(self) -> subprocess.Popen:
        return subprocess.Popen(self.cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def load(self) -> None:
        lib = ctypes.CDLL(str(self.path))
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in ("lvdgs_packed_fwd", "lvdgs_packed_fwd_bf16"):
            getattr(lib, fn).argtypes = [p] * 8 + [i] * 5 + [p]
        for fn in ("lvdgs_packed_bwd", "lvdgs_packed_bwd_bf16"):
            getattr(lib, fn).argtypes = [p] * 10 + [i] * 4 + [p]
        lib.lvdgs_packed_attrs.argtypes = [i, p, p]
        self.lib = lib

    def attrs(self) -> dict:
        every = rc.library_attrs(self.lib.lvdgs_packed_attrs)
        return {kernel: every[name] for kernel, name in KERNELS.items()}

    def forward(self, args, G: int, ntx: int, mode: int, bf16: bool, outs=None):
        tp, cg, _k0, goff, tids = args
        NB, _, TG, _ = tp.shape
        if outs is None:
            outs = (torch.empty((G + 1, 4, TG, rc.P), device=tp.device),
                    torch.empty((G + 1, TG, rc.P), device=tp.device),
                    torch.empty((NB, rc.KC, TG), dtype=torch.int32, device=tp.device),
                    torch.empty((G + 1, TG), dtype=torch.int32, device=tp.device))
        acc, trans, nt, march = outs
        fn = self.lib.lvdgs_packed_fwd_bf16 if bf16 else self.lib.lvdgs_packed_fwd
        rc._check_launch(fn(tp.data_ptr(), cg.data_ptr(), tids.data_ptr(), goff.data_ptr(),
                            acc.data_ptr(), trans.data_ptr(), nt.data_ptr(), march.data_ptr(), NB, G,
                            TG, ntx, mode, rc._stream()), f"{self.name} B4")
        return outs

    def backward(self, args, march, acc, trans, dacc, dtrans, G: int, ntx: int, bf16: bool,
                 dtp=None):
        tp, cg, _k0, goff, tids = args
        NB, _, TG, _ = tp.shape
        dtp = torch.empty_like(tp) if dtp is None else dtp
        fn = self.lib.lvdgs_packed_bwd_bf16 if bf16 else self.lib.lvdgs_packed_bwd
        rc._check_launch(fn(tp.data_ptr(), cg.data_ptr(), tids.data_ptr(), goff.data_ptr(),
                            march.data_ptr(), acc.data_ptr(), trans.data_ptr(), dacc.data_ptr(),
                            dtrans.data_ptr(), dtp.data_ptr(), NB, G, TG, ntx, rc._stream()),
                         f"{self.name} B5")
        return dtp


def build_all(builds: list[Build]) -> None:
    """Every build's nvcc at once; prints each one's ptxas lines."""
    procs = [(b, b.start()) for b in builds]
    for b, proc in procs:
        _out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {b.name}:\n{err}")
        for line in err.splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line or "spill" in line):
                print(f"ptxas [{b.name}]: {line.split('ptxas info    :')[-1].strip()}", flush=True)
            elif "bytes stack frame" in line:
                print(f"ptxas [{b.name}]: {line.strip()}", flush=True)
        b.load()


def _diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def ab_block(builds: list[Build], args, G: int, ntx: int, label: str) -> dict:
    """Every kernel of every build on one packed block: outputs against the
    first build's, B5 twice, march lengths against the plain forward's, and
    times in turns."""
    tp = args[0]
    NB = tp.shape[0]
    g = torch.Generator(device=tp.device).manual_seed(1)
    report = {}
    for bf16 in (False, True):
        suffix = "-bf16" if bf16 else ""
        acc, trans, _, _ = builds[0].forward(args, G, ntx, 0, bf16)
        dacc = torch.randn(acc.shape, generator=g, device=tp.device)
        dtrans = torch.randn(trans.shape, generator=g, device=tp.device)
        march_plain = rc.packed_blend_forward_plain(*args, G, ntx, with_nt=False, bf16=bf16)[3]
        modes = (("with_nt", 1), ("no_nt", 0)) + ((("probe", 2),) if not bf16 else ())
        for mode_name, mode in modes:
            case = f"B4{suffix} {mode_name}"
            outs = {b.name: b.forward(args, G, ntx, mode, bf16) for b in builds}
            ref = outs[builds[0].name]
            r = {"equal": {}, "max_diff": {}, "march_equals_plain": {}, "ms": {b.name: [] for b in builds}}
            for b in builds:
                o = outs[b.name]
                r["equal"][b.name] = all(torch.equal(x, y) for x, y in zip(o, ref))
                r["max_diff"][b.name] = max(_diff(x, y) for x, y in zip(o[:2], ref[:2]))
                r["march_equals_plain"][b.name] = bool(torch.equal(o[3], march_plain))
            for b in builds + builds[::-1]:
                o = outs[b.name]
                r["ms"][b.name].append(time_ms(lambda b=b, o=o: b.forward(args, G, ntx, mode, bf16, o),
                                               reps=10, inner=20))
            report[case] = r
        case = f"B5{suffix}"
        r = {"equal": {}, "max_diff": {}, "repeats": {}, "ms": {b.name: [] for b in builds}}
        dtps = {}
        for b in builds:
            march = b.forward(args, G, ntx, 0, bf16)[3]
            d1 = b.backward(args, march, acc, trans, dacc, dtrans, G, ntx, bf16)
            d2 = b.backward(args, march, acc, trans, dacc, dtrans, G, ntx, bf16)
            dtps[b.name] = (march, d1)
            r["repeats"][b.name] = bool(torch.equal(d1, d2))
        ref = dtps[builds[0].name][1]
        scale = ref.abs().amax(dim=(0, 1, 2), keepdim=True) + 1e-12
        for b in builds:
            d = dtps[b.name][1]
            r["equal"][b.name] = bool(torch.equal(d, ref))
            r["max_diff"][b.name] = float(((d - ref).abs() / scale).max())
        for b in builds + builds[::-1]:
            march, d = dtps[b.name]
            r["ms"][b.name].append(time_ms(
                lambda b=b, march=march, d=d: b.backward(args, march, acc, trans, dacc, dtrans, G,
                                                         ntx, bf16, d), reps=10, inner=20))
        report[case] = r
    torch.cuda.synchronize()
    for case, r in report.items():
        parts = []
        for b in builds:
            ms = "/".join(f"{t:.4f}" for t in r["ms"][b.name])
            extra = ""
            if "repeats" in r:
                extra += f", repeats {r['repeats'][b.name]}"
            if b.name in r.get("march_equals_plain", {}):
                extra += f", march = plain {r['march_equals_plain'][b.name]}"
            parts.append(f"{b.name} {ms} ms (equal to {builds[0].name}: {r['equal'][b.name]}, "
                         f"max diff {r['max_diff'][b.name]:.3e}{extra})")
        print(f"ab [{label}, NB {NB}] {case}: " + "; ".join(parts), flush=True)
    return report


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", action="append", required=True, metavar="NAME=DIR",
                        help="a directory holding blend_packed.cu; the first is the reference")
    parser.add_argument("--out", type=Path, help="write the report as JSON here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("packed_ab needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card_line()}", flush=True)
    builds = [Build(name, Path(d)) for name, d in (s.split("=", 1) for s in args.source)]
    build_all(builds)
    report = {"card": card_line(), "attrs": {b.name: b.attrs() for b in builds}, "blocks": {}}
    for b in builds:
        for kernel, a in report["attrs"][b.name].items():
            print(f"attrs [{b.name}] {kernel}: {a['registers']} registers, {a['local_bytes']} local "
                  f"bytes, {a['static_smem']} B static shared, {a['blocks_per_sm']} blocks of "
                  f"{a['threads']} per SM", flush=True)
    _dense, ntx, packed = street_packed_blocks(torch.device("cuda"))
    for bud, _sort, a, G in packed:
        label = f"random, budget {bud}"
        report["blocks"][f"{label}, NB {a[0].shape[0]}"] = ab_block(builds, a, G, ntx, label)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    print(f"card: {card_line()}", flush=True)


if __name__ == "__main__":
    main()
