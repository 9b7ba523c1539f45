"""Resident-table probe on the card: per-slot row loads from, and row
accumulates into, a (C + 1, 16) float32 field table held whole, against the
library calls that do the same work.

    python -m lvdgs_torch.tools.perf_resident [--reps 10]

Counterpart of ``tools/perf_resident.py`` (the TPU probe, which holds the
table in VMEM), at its shapes: C = 2^17 rows, 16 fields, T = 1848 tiles in
groups of TG = 8, K = 256 slots per tile, one row index per slot. It asks
whether the packed blend kernels could read the Gaussians' rows and
scatter their gradients in-kernel, in place of ``_gather_rows`` and the
``index_add_`` of its transpose. It prints the card, the kernels' ms and
ns per row (R1 ``resident_gather``, R2 ``resident_scatter``, each checked
against its plain version first) through the wrappers, their kernel ms
(straight from the library on preallocated outputs, and from a CUDA graph
of 20 calls, without the host's launch time; R2's zero and scatter passes
also apart) and the least time the card could take,
then the library baselines on the same inputs: the ``index_select`` row
gather (as ``_gather_rows`` calls it), ``embedding_bag`` sum over the
per-(group, lane) bags and ``index_add_``. The data comes from a
``torch.Generator`` with seed 0. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import resident_cuda as rs
from .timing import bound_ms, card_line, graph_ms, time_ms

C, NF, T, K, TG = 2**17, rs.NF, 1848, 256, 8
# R1 is held bit for bit (it adds in the plain version's order); R2 adds
# with atomics in any order, so it is held to 1e-5 of the table's largest
# magnitude
SCATTER_TOL = 1e-5
# R2's edge shapes (rows, G, K, TG): every slot on one row (full
# contention); K and the quarter-row count 4 G K TG multiples of neither a
# thread's 8 quarter rows nor a block's 2048; no group (the zero pass alone)
SCATTER_EDGES = [(1, 2, 64, 8), (1000, 3, 33, 7), (5000, 7, 301, 9), (10, 0, 16, 8)]


def make_inputs(C: int, T: int, K: int, TG: int, device, seed: int = 0):
    """(idx (G, K, TG) int32, fields (C + 1, 16), upd (G, K, TG, 16)), as
    the tool makes them: (K, Tpad) and (K, Tpad, 16) arrays read as
    (G, K, TG) and (G, K, TG, 16) without a transpose."""
    g = torch.Generator(device=device).manual_seed(seed)
    G = T // TG
    idx = torch.randint(0, C, (K, G * TG), generator=g, device=device, dtype=torch.int32)
    fields = torch.randn((C + 1, NF), generator=g, device=device)
    upd = torch.randn((K, G * TG, NF), generator=g, device=device)
    return idx.reshape(G, K, TG), fields, upd.reshape(G, K, TG, NF)


def scatter_edge_error(rows: int, G: int, K: int, TG: int, device) -> float:
    """R2 through its wrapper against its plain version at one edge shape,
    on inputs made by numpy from a seed: the largest difference over the
    table's largest magnitude (0 where both tables are zero)."""
    g = np.random.default_rng(rows + G + K + TG)
    idx = torch.tensor(g.integers(0, rows, (G, K, TG)), dtype=torch.int32, device=device)
    upd = torch.tensor(g.normal(size=(G, K, TG, NF)), dtype=torch.float32, device=device)
    out, ref = rs.resident_scatter(idx, upd, rows), rs.resident_scatter_plain(idx, upd, rows)
    scale = float(ref.abs().max())
    return float((out - ref).abs().max()) / scale if scale else float(out.abs().max())


def calls(idx, fields, upd) -> dict:
    """The five timed operations, as zero-argument callables: the two
    kernels (their plain versions for CPU tensors) and the three library
    baselines. The kernels' callables skip the wrappers' index range check
    (a host sync): check() makes it once on the same indices."""
    G, K_, TG_ = idx.shape
    rows = fields.shape[0]
    flat = idx.reshape(-1)
    upd_rows = upd.reshape(-1, NF)
    bags = idx.permute(0, 2, 1).reshape(G * TG_, K_)  # bag g * TG + tg: its K indices
    return {
        "gather": lambda: rs.resident_gather(idx, fields, check_rows=False),
        "scatter": lambda: rs.resident_scatter(idx, upd, rows, check_rows=False),
        "index_select gather": lambda: torch.index_select(fields, 0, flat),
        "embedding_bag sum": lambda: torch.nn.functional.embedding_bag(bags, fields, mode="sum"),
        "index_add_ scatter": lambda: torch.zeros((rows, NF), device=fields.device).index_add_(
            0, flat, upd_rows),
    }


def library_calls(idx, fields, upd) -> dict:
    """R1 and R2 launched straight from their library on preallocated
    outputs, as zero-argument callables: the kernels' own time, without the
    wrappers' checks and allocation; and R2's two passes apart, the zero
    pass ("scatter zero": the entry point with G = 0) and the scatter pass
    ("scatter add", into the table without zeroing it). The index range
    check is made here, once; CUDA tensors only."""
    G, K_, TG_ = idx.shape
    rows = fields.shape[0]
    rs._check_rows(idx, rows)
    lib = rs._library()
    gather_out = torch.empty((G * TG_, NF), device=idx.device)
    scatter_out = torch.empty((rows, NF), device=idx.device)

    def launch(fn, inp, out, name, G=G):
        rs._check_launch(fn(idx.data_ptr(), inp.data_ptr(), out.data_ptr(), G, K_, TG_, rows, rs._stream()),
                         name)

    return {"gather": lambda: launch(lib.lvdgs_resident_gather, fields, gather_out, "resident_gather"),
            "scatter": lambda: launch(lib.lvdgs_resident_scatter, upd, scatter_out, "resident_scatter"),
            "scatter zero": lambda: launch(lib.lvdgs_resident_scatter, upd, scatter_out, "resident_scatter",
                                           G=0),
            "scatter add": lambda: launch(lib.lvdgs_resident_scatter_add, upd, scatter_out,
                                          "resident_scatter")}


def check(idx, fields, upd, ops: dict) -> dict:
    """Errors of the kernels against their plain versions, and of the
    library baselines against the kernels. Raises where a kernel
    disagrees."""
    rows = fields.shape[0]
    gather, scatter = rs.resident_gather(idx, fields), rs.resident_scatter(idx, upd, rows)
    gather_p = rs.resident_gather_plain(idx, fields)
    scatter_p = rs.resident_scatter_plain(idx, upd, rows)
    err = {
        "gather": float((gather - gather_p).abs().max()),
        "scatter": float((scatter - scatter_p).abs().max()),
        "scatter_rel": float((scatter - scatter_p).abs().max() / scatter_p.abs().max()),
        "embedding_bag sum": float((ops["embedding_bag sum"]() - gather).abs().max()),
        "index_add_ scatter": float((ops["index_add_ scatter"]() - scatter).abs().max()),
    }
    if err["gather"] != 0.0:
        raise RuntimeError(f"resident_gather differs from its plain version by {err['gather']:.3e}")
    if not err["scatter_rel"] <= SCATTER_TOL:
        raise RuntimeError(f"resident_scatter differs from its plain version by {err['scatter_rel']:.3e} "
                           f"of the table's largest magnitude (tolerance {SCATTER_TOL:.0e})")
    return err


def bounds(idx, fields) -> dict:
    """Least time on the card for R1 and R2, with what bounds it. Bytes:
    each input read once, each output written once. R1 reads the rows its
    indices name (each distinct row once), the indices, and writes
    (G * TG, 16); R2 reads the updates and indices and writes the table.
    One add per slot and field."""
    G, K_, TG_ = idx.shape
    slots = idx.numel()
    row_bytes = NF * 4
    distinct = int(torch.unique(idx).numel())
    gather = bound_ms(distinct * row_bytes + slots * 4 + G * TG_ * row_bytes, slots * NF)
    scatter = bound_ms(slots * row_bytes + slots * 4 + fields.shape[0] * row_bytes, slots * NF)
    return {"gather": gather, "scatter": scatter, "distinct_rows": distinct}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10, help="CUDA-event timings per median")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("perf_resident needs a CUDA card")
    dev = torch.device("cuda")
    idx, fields, upd = make_inputs(C, T, K, TG, dev)
    ops = calls(idx, fields, upd)
    err = check(idx, fields, upd, ops)
    bnd = bounds(idx, fields)
    n_rows = idx.numel()
    print(f"device: {torch.cuda.get_device_name(0)} ({card_line()}); C={C} NF={NF} rows/call={n_rows}")
    print(f"resident gather (R1): error {err['gather']:.3e} against its plain version (bit for bit)")
    print(f"resident scatter (R2): error {err['scatter_rel']:.3e} of the table's largest magnitude "
          f"(tolerance {SCATTER_TOL:.0e}; atomics add in any order)")
    # 20 launches per timed span keep the CUDA events' own overhead out of
    # these short kernels' times; ms through the wrapper, kernel ms straight
    # from the library
    lib = library_calls(idx, fields, upd)
    for name in ("gather", "scatter"):
        ms = time_ms(ops[name], reps=args.reps, inner=20)
        kernel_ms = time_ms(lib[name], reps=args.reps, inner=20)
        b, by = bnd[name]
        print(f"cuda resident {name}:{' ' * (8 - len(name))}{ms:8.4f} ms  ({ms * 1e6 / n_rows:.3f} ns/row)"
              f"  kernel {kernel_ms:.4f} ms  bound {b:.4f} ms ({by})")
    # a launch of a few microseconds from Python waits on the host: from a
    # CUDA graph, the device's own time
    print("cuda resident, from a CUDA graph: "
          + ", ".join(f"{name} {graph_ms(lib[name], reps=args.reps):.4f} ms"
                      for name in ("gather", "scatter", "scatter zero", "scatter add")))
    for name in ("index_select gather", "embedding_bag sum", "index_add_ scatter"):
        ms = time_ms(ops[name], reps=args.reps, inner=20)
        print(f"{name}:{' ' * (22 - len(name))}{ms:8.4f} ms  ({ms * 1e6 / n_rows:.3f} ns/row)")


if __name__ == "__main__":
    main()
