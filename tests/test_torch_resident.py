"""The resident-table probe's plain kernels (R1 gather, R2 scatter) of
lvdgs_torch against the Pallas kernels of tools/perf_resident.py on the CPU,
and the port's entry point lvdgs_torch.tools.perf_resident at tiny shapes.

The tool's jitted run_gather/run_scatter have no interpret flag, so the test
loads the tool unchanged, sets its shape globals (the kernel bodies read
C, K, TG and NF when traced) and builds the same pallas_call with the tool's
BlockSpecs and interpret=True. Both sides add in the same order (R1 in k
order from zero, R2 in grid order, which is flat slot order), so they are
held bit for bit; the index tables are small enough to repeat rows often.
"""
import importlib.util
import os
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lvdgs_torch.ops import resident_cuda as rs
from lvdgs_torch.tools import perf_resident as tpr
from torch_parity import to_np

TOOL = Path(__file__).resolve().parent.parent / "tools" / "perf_resident.py"
# (C, T, K, TG): the shapes the tool's kernels were first checked at, and
# the tool's own lane count
SHAPES = [(64, 16, 8, 4), (200, 24, 32, 8)]


def _tool(C, T, K, TG):
    """tools/perf_resident.py as a fresh module with its shape globals set
    (its import-time environment defaults are undone)."""
    spec = importlib.util.spec_from_file_location(f"perf_resident_{C}_{T}_{K}_{TG}", TOOL)
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.dict(os.environ):
        spec.loader.exec_module(mod)
    mod.C, mod.T, mod.K, mod.TG = C, T, K, TG
    return mod


def _pallas_gather(pr, idx, fields):
    G = pr.T // pr.TG
    return pl.pallas_call(
        pr.gather_kernel,
        grid=(G,),
        in_specs=[
            pl.BlockSpec((1, pr.K, pr.TG), lambda g: (g, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((pr.C + 1, pr.NF), lambda g: (0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((pr.TG, pr.NF), lambda g: (g, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((G * pr.TG, pr.NF), jnp.float32),
        interpret=True,
    )(idx.reshape(G, pr.K, pr.TG), fields)


def _pallas_scatter(pr, idx, upd):
    G = pr.T // pr.TG
    return pl.pallas_call(
        pr.scatter_kernel,
        grid=(G,),
        in_specs=[
            pl.BlockSpec((1, pr.K, pr.TG), lambda g: (g, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, pr.K, pr.TG, pr.NF), lambda g: (g, 0, 0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((pr.C + 1, pr.NF), lambda g: (0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((pr.C + 1, pr.NF), jnp.float32),
        interpret=True,
    )(idx.reshape(G, pr.K, pr.TG), upd.reshape(G, pr.K, pr.TG, pr.NF))


def _inputs(C, T, K, TG, seed):
    """The tool's inputs at a small size: (K, Tpad) indices, (C + 1, 16)
    fields, (K, Tpad, 16) updates."""
    rng = np.random.default_rng(seed)
    Tpad = (T // TG) * TG
    idx = rng.integers(0, C, size=(K, Tpad)).astype(np.int32)
    fields = rng.normal(size=(C + 1, rs.NF)).astype(np.float32)
    upd = rng.normal(size=(K, Tpad, rs.NF)).astype(np.float32)
    return idx, fields, upd


@pytest.mark.parametrize("C,T,K,TG", SHAPES, ids=lambda v: str(v))
def test_plain_gather_matches_pallas(C, T, K, TG):
    pr = _tool(C, T, K, TG)
    idx, fields, upd = _inputs(C, T, K, TG, seed=C + K)
    ref = np.asarray(_pallas_gather(pr, jnp.asarray(idx), jnp.asarray(fields)))
    G = T // TG
    out = rs.resident_gather(torch.tensor(idx).reshape(G, K, TG), torch.tensor(fields))
    np.testing.assert_array_equal(to_np(out), ref)
    # the raw reshape, not a transpose: reading bag (g, tg) as column
    # g * TG + tg of the (K, Tpad) array sums other rows
    transposed = fields[idx.T.reshape(G, TG, K)].sum(axis=2).reshape(G * TG, rs.NF)
    assert not np.allclose(transposed, ref)


@pytest.mark.parametrize("C,T,K,TG", SHAPES, ids=lambda v: str(v))
def test_plain_scatter_matches_pallas(C, T, K, TG):
    pr = _tool(C, T, K, TG)
    idx, fields, upd = _inputs(C, T, K, TG, seed=C + K + 1)
    ref = np.asarray(_pallas_scatter(pr, jnp.asarray(idx), jnp.asarray(upd)))
    G = T // TG
    out = rs.resident_scatter(torch.tensor(idx).reshape(G, K, TG),
                              torch.tensor(upd).reshape(G, K, TG, rs.NF), C + 1)
    np.testing.assert_array_equal(to_np(out), ref)
    flat = np.zeros((C + 1, rs.NF), np.float32)
    np.add.at(flat, idx.reshape(-1), upd.reshape(-1, rs.NF))
    np.testing.assert_array_equal(ref, flat)
    assert np.bincount(idx.reshape(-1)).max() > 1  # rows repeat


def test_entry_point_core_on_cpu():
    """perf_resident's inputs, operations, checks and bounds at tiny shapes
    on the CPU (the kernels' plain versions): the library baselines compute
    the same function as the kernels, and the entry point itself refuses
    to run without a card."""
    idx, fields, upd = tpr.make_inputs(96, 24, 16, 8, "cpu")
    assert idx.shape == (3, 16, 8) and fields.shape == (97, rs.NF) and upd.shape == (3, 16, 8, rs.NF)
    ops = tpr.calls(idx, fields, upd)
    assert set(ops) == {"gather", "scatter", "index_select gather", "embedding_bag sum",
                        "index_add_ scatter"}
    err = tpr.check(idx, fields, upd, ops)
    assert err["gather"] == 0.0 and err["scatter"] == 0.0
    assert err["embedding_bag sum"] < 1e-5 and err["index_add_ scatter"] < 1e-5
    rows = ops["index_select gather"]()
    assert torch.equal(rows, fields[idx.reshape(-1).long()])
    bnd = tpr.bounds(idx, fields)
    assert bnd["gather"][1] == "bytes" and bnd["scatter"][1] == "bytes"
    assert 0 < bnd["distinct_rows"] <= 96
    before = [w.launches.count for w in rs.KERNEL_WRAPPERS]
    rs.resident_gather(idx, fields)
    assert [w.launches.count for w in rs.KERNEL_WRAPPERS] == before  # plain versions uncounted
    with pytest.raises(ValueError):
        rs.resident_gather(idx.long(), fields)
    with pytest.raises(ValueError):
        rs.resident_scatter(idx, upd[..., :8].contiguous(), 97)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            tpr.main([])


@pytest.mark.parametrize("bad", [-1, 97])
@pytest.mark.parametrize("kernel", ["gather", "scatter"])
def test_wrappers_refuse_indices_outside_the_table(kernel, bad):
    """An index outside [0, rows) raises before any launch (on the card it
    would read or write outside the table)."""
    idx, fields, upd = tpr.make_inputs(96, 24, 16, 8, "cpu")
    idx = idx.clone()
    idx[1, 3, 5] = bad
    with pytest.raises(ValueError, match="indices must lie in"):
        if kernel == "gather":
            rs.resident_gather(idx, fields)
        else:
            rs.resident_scatter(idx, upd, fields.shape[0])
