"""Builds of the blend kernels (the packed B4, B5 and their bf16 variants, the
dense B1 and B2, the median B3) and of the resident-table kernels (R1, R2)
held against each other on one card.

    python -m lvdgs_torch.tools.packed_ab --source NAME=DIR [--source NAME=DIR ...]
        [--blocks FILE] [--out FILE] [--resident-only]

Each DIR holds a ``blend_packed.cu``, a ``blend.cu`` and a ``resident.cu``
with the headers they include: this tree's ``lvdgs_torch/csrc``, a parent
commit's unpacked with
``git archive``, or a copy with one change to measure. Each source is built
with the shipped flags into its own library (every nvcc at once); nvcc's
``-Xptxas -v`` lines are printed with each kernel's registers, local
(spill) bytes, static shared memory and most resident blocks per SM (the
libraries' attrs functions). A ``blend.cu`` whose ``lvdgs_blend_fwd``
writes no march lengths (the ABI before they existed) is driven without
them: its backward applies the stop rule itself.

Packed: on each block (the random street-shaped block packed at NB 348, 464
and 928, ``lvdgs_torch.tools.blocks``) every kernel of every build runs on
the same inputs: B4 with touch counts, without and as the probe, B4-bf16
with and without counts, B5 and B5-bf16 on the first build's forward
outputs and one random cotangent. Dense: B1, B2 and B3 on the random
street-shaped block (K 256, T 1848), B2 on the first build's forward
outputs and one random cotangent. ``--blocks`` adds the final-map blocks
that ``chip_smoke.py --save-blocks`` wrote (the packed run's three packs
and the packed and dense runs' dense blocks). Resident: R1 and R2 at the
probe's shapes (``lvdgs_torch.tools.perf_resident``, seed 0), and R2's
zero and scatter passes each alone (``--resident-only``: R1 and R2
alone). Each output
is compared bit for bit with the first build's (R2, whose atomics add in
any order, within its tolerance of the plain version's), each march
length with the plain forward's, each backward and B3 are launched twice
to show that they repeat, and each kernel is timed straight from its
library (median of 10 CUDA-event timings of 20 back-to-back launches) in
turns: the builds in order, then in reverse; R1 and R2 also from a CUDA
graph of 20 calls (``timing.graph_ms``), which leaves out the host's
time to launch them. Needs a CUDA card and nvcc.

To hold whole street runs of two checkouts against each other, use
``chip_smoke.py --deterministic-street`` (``--dense`` for B1 and B2).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import rasterizer_cuda as rc
from ..ops import resident_cuda as rs
from . import perf_resident as pr
from .blocks import street_packed_blocks
from .timing import card_line, graph_ms, time_ms

ROOT = Path(__file__).resolve().parents[2]
_BUILD = ROOT / "lvdgs_torch" / "_build" / "ab"
# the kernels compared, as the attrs functions name them: B4 and B4-bf16
# without touch counts, as tracking and mapping launch them
KERNELS = {"B4": "packed_fwd_kernel<false, NT_NONE>", "B4-bf16": "packed_fwd_kernel<true, NT_NONE>",
           "B5": "packed_bwd_kernel<false>", "B5-bf16": "packed_bwd_kernel<true>",
           "B1": "blend_fwd_kernel", "B2": "blend_bwd_kernel", "B3": "median_depth_kernel",
           "R1": "resident_gather_kernel", "R2": "resident_scatter_kernel"}
_SOURCES = {"packed": "blend_packed.cu", "dense": "blend.cu", "resident": "resident.cu"}


class Build:
    """One build of blend_packed.cu, blend.cu and resident.cu from one
    directory, loaded with ctypes."""

    def __init__(self, name: str, src_dir: Path):
        self.name = name
        flags = [*rc._NVCC_FLAGS, "-fmad=false"]  # the shipped build's, with -Xptxas -v
        h = hashlib.sha256(" ".join(flags).encode())
        for f in sorted(src_dir.iterdir()):
            if f.suffix in (".cu", ".cuh"):
                h.update(f.name.encode() + f.read_bytes())
        out = _BUILD / f"{name}-{h.hexdigest()[:12]}"
        out.mkdir(parents=True, exist_ok=True)
        self.paths = {lib: out / f"lib{lib}.so" for lib in _SOURCES}
        self.cmds = {lib: [rc._nvcc(), *flags, "-o", str(self.paths[lib]), str((src_dir / src).resolve())]
                     for lib, src in _SOURCES.items()}
        # whether lvdgs_blend_fwd writes march lengths (and lvdgs_blend_bwd reads them)
        fwd = re.search(r"int lvdgs_blend_fwd\(([^)]*)\)", (src_dir / "blend.cu").read_text())
        self.march_abi = fwd is not None and "march" in fwd.group(1)

    def start(self) -> dict:
        return {lib: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for lib, cmd in self.cmds.items()}

    def load(self) -> None:
        packed, dense, resident = (ctypes.CDLL(str(self.paths[lib])) for lib in _SOURCES)
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in ("lvdgs_packed_fwd", "lvdgs_packed_fwd_bf16"):
            getattr(packed, fn).argtypes = [p] * 8 + [i] * 5 + [p]
        for fn in ("lvdgs_packed_bwd", "lvdgs_packed_bwd_bf16"):
            getattr(packed, fn).argtypes = [p] * 10 + [i] * 4 + [p]
        m = int(self.march_abi)
        dense.lvdgs_blend_fwd.argtypes = [p] * (5 + m) + [i] * 3 + [p]
        dense.lvdgs_blend_bwd.argtypes = [p] * (7 + m) + [i] * 3 + [p]
        dense.lvdgs_median_depth.argtypes = [p] * 4 + [i] * 3 + [p]
        # lvdgs_resident_scatter_add (the scatter pass alone), where the build exports it
        self.scatter_add = hasattr(resident, "lvdgs_resident_scatter_add")
        for fn in ("gather", "scatter") + (("scatter_add",) if self.scatter_add else ()):
            getattr(resident, f"lvdgs_resident_{fn}").argtypes = [p] * 3 + [i] * 4 + [p]
        for lib, fn in ((packed, "lvdgs_packed_attrs"), (dense, "lvdgs_blend_attrs"),
                        (resident, "lvdgs_resident_attrs")):
            getattr(lib, fn).argtypes = [i, p, p]
        self.lib, self.dense, self.resident = packed, dense, resident

    def attrs(self) -> dict:
        every = {**rc.library_attrs(self.lib.lvdgs_packed_attrs),
                 **rc.library_attrs(self.dense.lvdgs_blend_attrs),
                 **rc.library_attrs(self.resident.lvdgs_resident_attrs)}
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

    def dense_forward(self, tp, counts, ntx: int, outs=None):
        """B1: (acc, trans, nt, march), march None for the ABI without it."""
        K, T, _ = tp.shape
        if outs is None:
            outs = (torch.empty((T, 4, rc.P), device=tp.device), torch.empty((T, rc.P), device=tp.device),
                    torch.empty((T, K), dtype=torch.int32, device=tp.device),
                    torch.empty((T,), dtype=torch.int32, device=tp.device) if self.march_abi else None)
        ptrs = [x.data_ptr() for x in outs if x is not None]
        rc._check_launch(self.dense.lvdgs_blend_fwd(tp.data_ptr(), counts.data_ptr(), *ptrs, K, T, ntx,
                                                    rc._stream()), f"{self.name} B1")
        return outs

    def dense_backward(self, tp, counts, march, acc, trans, dacc, dtrans, ntx: int, dtp=None):
        """B2 (`march` unused by the ABI without it)."""
        K, T, _ = tp.shape
        dtp = torch.empty_like(tp) if dtp is None else dtp
        ins = [tp, counts] + ([march] if self.march_abi else []) + [acc, trans, dacc, dtrans, dtp]
        rc._check_launch(self.dense.lvdgs_blend_bwd(*(x.data_ptr() for x in ins), K, T, ntx, rc._stream()),
                         f"{self.name} B2")
        return dtp

    def median(self, tp, counts, ntx: int, outs=None):
        """B3: (dmed, opac)."""
        K, T, _ = tp.shape
        if outs is None:
            outs = (torch.empty((T, rc.P), device=tp.device), torch.empty((T, rc.P), device=tp.device))
        rc._check_launch(self.dense.lvdgs_median_depth(tp.data_ptr(), counts.data_ptr(), *(x.data_ptr() for x in outs),
                                                       K, T, ntx, rc._stream()), f"{self.name} B3")
        return outs

    def resident_call(self, fn: str, idx, src, rows: int, out=None):
        """R1 (fn "gather", src the table), R2 ("scatter", src the updates)
        or R2's scatter pass alone ("scatter_add") into out."""
        G, K, TG = idx.shape
        if out is None:
            out = torch.empty((G * TG if fn == "gather" else rows, pr.NF), device=idx.device)
        rc._check_launch(getattr(self.resident, f"lvdgs_resident_{fn}")(
            idx.data_ptr(), src.data_ptr(), out.data_ptr(), G, K, TG, rows, rc._stream()),
            f"{self.name} R{1 if fn == 'gather' else 2}")
        return out


def build_all(builds: list[Build]) -> None:
    """Every build's nvcc at once; prints each one's ptxas lines."""
    procs = [(b, b.start()) for b in builds]
    for b, libs in procs:
        for lib, proc in libs.items():
            _out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {b.name} {_SOURCES[lib]}:\n{err}")
            for line in err.splitlines():
                if "ptxas info" in line and ("Used" in line or "Compiling" in line or "spill" in line):
                    print(f"ptxas [{b.name}]: {line.split('ptxas info    :')[-1].strip()}", flush=True)
                elif "bytes stack frame" in line:
                    print(f"ptxas [{b.name}]: {line.strip()}", flush=True)
        b.load()


def _diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _times(builds: list[Build], run, timer=time_ms) -> dict:
    """{build: [ms in order, ms in reverse]} of run(build), in turns, each
    taken by `timer` (timing.time_ms, or timing.graph_ms: from a CUDA graph
    of the launches, no host time)."""
    ms = {b.name: [] for b in builds}
    for b in builds + builds[::-1]:
        ms[b.name].append(timer(lambda b=b: run(b), reps=10, inner=20))
    return ms


def _print(builds: list[Build], label: str, report: dict) -> None:
    for case, r in report.items():
        parts = []
        for b in builds:
            ms = "/".join(f"{t:.4f}" for t in r["ms"][b.name])
            extra = ""
            if "repeats" in r:
                extra += f", repeats {r['repeats'][b.name]}"
            if b.name in r.get("march_equals_plain", {}):
                extra += f", march = plain {r['march_equals_plain'][b.name]}"
            held = (f"within tolerance: {r['within'][b.name]}" if "within" in r
                    else f"equal to {builds[0].name}: {r['equal'][b.name]}")
            parts.append(f"{b.name} {ms} ms ({held}, max diff {r['max_diff'][b.name]:.3e}{extra})")
        print(f"ab [{label}] {case}: " + "; ".join(parts), flush=True)


def ab_block(builds: list[Build], args, G: int, ntx: int, label: str) -> dict:
    """Every packed kernel of every build on one packed block: outputs
    against the first build's, B5 twice, march lengths against the plain
    forward's, and times in turns."""
    tp = args[0]
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
            outs = {b.name: b.forward(args, G, ntx, mode, bf16) for b in builds}
            ref = outs[builds[0].name]
            r = {"equal": {}, "max_diff": {}, "march_equals_plain": {}}
            for b in builds:
                o = outs[b.name]
                r["equal"][b.name] = all(torch.equal(x, y) for x, y in zip(o, ref))
                r["max_diff"][b.name] = max(_diff(x, y) for x, y in zip(o[:2], ref[:2]))
                r["march_equals_plain"][b.name] = bool(torch.equal(o[3], march_plain))
            r["ms"] = _times(builds, lambda b: b.forward(args, G, ntx, mode, bf16, outs[b.name]))
            report[f"B4{suffix} {mode_name}"] = r
        r = {"equal": {}, "max_diff": {}, "repeats": {}}
        dtps = {}
        for b in builds:
            march = b.forward(args, G, ntx, 0, bf16)[3]
            d1 = b.backward(args, march, acc, trans, dacc, dtrans, G, ntx, bf16)
            d2 = b.backward(args, march, acc, trans, dacc, dtrans, G, ntx, bf16)
            dtps[b.name] = (march, d1)
            r["repeats"][b.name] = bool(torch.equal(d1, d2))
        _hold(builds, r, {k: v[1] for k, v in dtps.items()})
        r["ms"] = _times(builds, lambda b: b.backward(args, dtps[b.name][0], acc, trans, dacc, dtrans,
                                                      G, ntx, bf16, dtps[b.name][1]))
        report[f"B5{suffix}"] = r
    torch.cuda.synchronize()
    _print(builds, f"{label}, NB {tp.shape[0]}", report)
    return report


def _hold(builds: list[Build], r: dict, dtps: dict) -> None:
    """A backward's outputs against the first build's: equal bits, and the
    largest difference relative to each field's largest gradient."""
    ref = dtps[builds[0].name]
    scale = ref.abs().amax(dim=tuple(range(ref.dim() - 1)), keepdim=True) + 1e-12
    for b in builds:
        d = dtps[b.name]
        r["equal"][b.name] = bool(torch.equal(d, ref))
        r["max_diff"][b.name] = float(((d - ref).abs() / scale).max())


def ab_dense_block(builds: list[Build], tp, counts, ntx: int, label: str) -> dict:
    """B1, B2 and B3 of every build on one dense block: acc, trans and touch
    counts against the first build's, march lengths (where the ABI has them)
    against the plain forward's, B2 on the first build's forward outputs
    against the first build's and twice, B3's dmed and opac against the
    first build's and twice, and times in turns."""
    g = torch.Generator(device=tp.device).manual_seed(1)
    outs = {b.name: b.dense_forward(tp, counts, ntx) for b in builds}
    ref = outs[builds[0].name]
    march_plain = rc.blend_forward_plain(tp, counts, ntx)[3]
    r1 = {"equal": {}, "max_diff": {}, "march_equals_plain": {}}
    for b in builds:
        o = outs[b.name]
        r1["equal"][b.name] = all(torch.equal(x, y) for x, y in zip(o[:3], ref[:3]))
        r1["max_diff"][b.name] = max(_diff(x, y) for x, y in zip(o[:2], ref[:2]))
        if o[3] is not None:
            r1["march_equals_plain"][b.name] = bool(torch.equal(o[3], march_plain))
    r1["ms"] = _times(builds, lambda b: b.dense_forward(tp, counts, ntx, outs[b.name]))
    acc, trans = ref[0], ref[1]
    dacc = torch.randn(acc.shape, generator=g, device=tp.device)
    dtrans = torch.randn(trans.shape, generator=g, device=tp.device)
    r2 = {"equal": {}, "max_diff": {}, "repeats": {}}
    dtps = {}
    for b in builds:
        march = outs[b.name][3]
        d1 = b.dense_backward(tp, counts, march, acc, trans, dacc, dtrans, ntx)
        d2 = b.dense_backward(tp, counts, march, acc, trans, dacc, dtrans, ntx)
        dtps[b.name] = d1
        r2["repeats"][b.name] = bool(torch.equal(d1, d2))
    _hold(builds, r2, dtps)
    r2["ms"] = _times(builds, lambda b: b.dense_backward(tp, counts, outs[b.name][3], acc, trans, dacc,
                                                         dtrans, ntx, dtps[b.name]))
    r3 = {"equal": {}, "max_diff": {}, "repeats": {}}
    meds = {b.name: b.median(tp, counts, ntx) for b in builds}
    for b in builds:
        o, ref3 = meds[b.name], meds[builds[0].name]
        r3["equal"][b.name] = all(torch.equal(x, y) for x, y in zip(o, ref3))
        r3["max_diff"][b.name] = max(_diff(x, y) for x, y in zip(o, ref3))
        r3["repeats"][b.name] = all(torch.equal(x, y) for x, y in zip(b.median(tp, counts, ntx), o))
    r3["ms"] = _times(builds, lambda b: b.median(tp, counts, ntx, meds[b.name]))
    report = {"B1": r1, "B2": r2, "B3": r3}
    torch.cuda.synchronize()
    _print(builds, f"{label}, K {tp.shape[0]}, T {tp.shape[1]}", report)
    return report


def ab_resident(builds: list[Build]) -> dict:
    """R1 and R2 of every build at the probe's shapes: R1 against the first
    build's and the plain version's bit for bit, R2 against the plain
    version within its tolerance (its atomics add in any order), and times
    in turns."""
    idx, fields, upd = pr.make_inputs(pr.C, pr.T, pr.K, pr.TG, torch.device("cuda"))
    rows = fields.shape[0]
    rs._check_rows(idx, rows)
    report = {}
    for fn, case, src in (("gather", "R1", fields), ("scatter", "R2", upd)):
        outs = {b.name: b.resident_call(fn, idx, src, rows) for b in builds}
        ref = outs[builds[0].name]
        r = {"max_diff": {}}
        if fn == "gather":
            plain = rs.resident_gather_plain(idx, fields)
            r["equal"] = {b.name: bool(torch.equal(outs[b.name], ref) and torch.equal(outs[b.name], plain))
                          for b in builds}
            for b in builds:
                r["max_diff"][b.name] = _diff(outs[b.name], plain)
        else:
            plain = rs.resident_scatter_plain(idx, upd, rows)
            for b in builds:
                r["max_diff"][b.name] = _diff(outs[b.name], plain) / float(plain.abs().max())
            r["within"] = {b.name: r["max_diff"][b.name] <= pr.SCATTER_TOL for b in builds}
        run = lambda b, fn=fn, src=src: b.resident_call(fn, idx, src, rows, outs[b.name])  # noqa: E731
        r["ms"], r["graph_ms"] = _times(builds, run), _times(builds, run, graph_ms)
        report[case] = r
    torch.cuda.synchronize()
    _print(builds, f"resident, {idx.numel()} slots (R1: equal to the plain version too; R2: within "
                   f"{pr.SCATTER_TOL:.0e} of the plain version, relative)", report)
    # R2's two passes apart, in turns: the zero pass alone (the entry point
    # with G = 0) and, in the builds that export it, the scatter pass alone
    # (into the same table, without zeroing)
    out = torch.empty((rows, pr.NF), device=idx.device)
    adders = [b for b in builds if b.scatter_add]
    for case, some, run in (
            ("R2 zero", builds, lambda b: b.resident_call("scatter", idx[:0], upd, rows, out)),
            ("R2 scatter", adders, lambda b: b.resident_call("scatter_add", idx, upd, rows, out))):
        report[case] = {"ms": _times(some, run), "graph_ms": _times(some, run, graph_ms)}
    for case, r in report.items():
        print(f"ab [resident] {case}, ms straight from the library / from a CUDA graph: "
              + "; ".join(f"{b.name} " + ("/".join(f"{t:.4f}" for t in r["ms"][b.name]) + " / "
                                          + "/".join(f"{t:.4f}" for t in r["graph_ms"][b.name])
                                          if b.name in r["ms"] else "not exported") for b in builds),
              flush=True)
    return report


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", action="append", required=True, metavar="NAME=DIR",
                        help="a directory holding blend_packed.cu, blend.cu and resident.cu; the first is "
                             "the reference")
    parser.add_argument("--blocks", type=Path,
                        help="also the final-map blocks that chip_smoke.py --save-blocks wrote")
    parser.add_argument("--out", type=Path, help="write the report as JSON here")
    parser.add_argument("--resident-only", action="store_true", help="R1 and R2 alone")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("packed_ab needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card_line()}", flush=True)
    builds = [Build(name, Path(d)) for name, d in (s.split("=", 1) for s in args.source)]
    build_all(builds)
    report = {"card": card_line(), "attrs": {b.name: b.attrs() for b in builds}, "blocks": {}}
    for b in builds:
        print(f"[{b.name}] blend.cu march ABI: {b.march_abi}", flush=True)
        for kernel, a in report["attrs"][b.name].items():
            print(f"attrs [{b.name}] {kernel}: {a['registers']} registers, {a['local_bytes']} local "
                  f"bytes, {a['static_smem']} B static shared, {a['blocks_per_sm']} blocks of "
                  f"{a['threads']} per SM", flush=True)
    dev = torch.device("cuda")
    report["blocks"]["resident"] = ab_resident(builds)
    if args.resident_only:
        packed, saved = [], None
    else:
        (tp, counts), ntx, packed = street_packed_blocks(dev)
        report["blocks"]["random, dense"] = ab_dense_block(builds, tp, counts, ntx, "random, dense")
        saved = torch.load(args.blocks) if args.blocks else None
    for bud, _sort, a, G in packed:
        label = f"random, budget {bud}"
        report["blocks"][f"{label}, NB {a[0].shape[0]}"] = ab_block(builds, a, G, ntx, label)
    if saved:
        for run, (btp, bcounts, bntx) in saved["dense"].items():
            label = f"final map, {run}, dense"
            report["blocks"][label] = ab_dense_block(builds, btp.to(dev), bcounts.to(dev), bntx, label)
        blocks, G, bntx = saved["packed"]
        for name, a in blocks:
            label = f"final map, packed run, {name}"
            report["blocks"][label] = ab_block(builds, [x.to(dev) for x in a], G, bntx, label)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    print(f"card: {card_line()}", flush=True)


if __name__ == "__main__":
    main()
