"""The examples' gather and scatter kernels (Pallas kernels 8 and 9) against
the port's plain twins, on the CPU.

The JAX kernels run in interpret mode with the specs of their callers:
`examples/bench_vmem_gather.py` is loaded as a module (it does no work at
import); `examples/proto_pallas_gather.py` runs its benchmark at import,
so its two kernel functions are taken from its source with `ast` and run
with a small TILE. Inputs come from numpy seeds. The gathers must be
bit-equal (compared as uint32 words); the scatter is a sum of f32 terms,
serial in index order in the TPU kernel, and must be within
2 (n - 1) 2^-24 sum|terms| of the twin per entry.
"""

import ast
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from radnerf_tpu_torch import kernels
from radnerf_tpu_torch.examples import bench_vmem_gather as tvg
from radnerf_tpu_torch.examples import proto_pallas_gather as tpg

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
VMEM = pltpu.VMEM
R, E = 64, 512              # kernel 8: table rows, gathered words
T, M, TILE = 256, 1024, 128  # kernel 9: table rows, updates, grid tile
NEW_KERNELS = ("tal_sublane", "tal_sublane_l2", "rowgather_onehot",
               "pallas_gather", "pallas_scatter")


@pytest.fixture(scope="module")
def vmem_mod():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_vmem_gather", EXAMPLES / "bench_vmem_gather.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def proto_kernels():
    """gather_kernel and scatter_kernel from proto_pallas_gather.py's
    source, bound to TILE."""
    tree = ast.parse((EXAMPLES / "proto_pallas_gather.py").read_text())
    funcs = [n for n in tree.body if isinstance(n, ast.FunctionDef)
             and n.name in ("gather_kernel", "scatter_kernel")]
    assert len(funcs) == 2
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "TILE": TILE}
    exec(compile(ast.Module(body=funcs, type_ignores=[]),
                 "proto_pallas_gather.py", "exec"), ns)
    return ns["gather_kernel"], ns["scatter_kernel"]


def _words(seed):
    rng = np.random.default_rng(seed)
    tbl = rng.integers(0, 2**32, (R, 128), dtype=np.uint32)
    flat = rng.integers(0, R * 128, (E,), dtype=np.int64).astype(np.int32)
    rows = rng.integers(0, R, (E // 128, 128), dtype=np.int64).astype(
        np.int32)
    return tbl, flat, rows


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", [0, 1])
def test_tal_sublane_twin_equals_jax_kernel(vmem_mod, seed):
    tbl, _, rows = _words(seed)
    ref = pl.pallas_call(
        vmem_mod._tal_kernel,
        out_shape=jax.ShapeDtypeStruct(rows.shape, jnp.uint32),
        in_specs=[pl.BlockSpec(memory_space=VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=VMEM), interpret=True,
    )(jnp.asarray(tbl), jnp.asarray(rows))
    ref = np.asarray(ref)
    np.testing.assert_array_equal(
        ref, np.take_along_axis(tbl, rows, axis=0))
    got = tvg.tal_sublane(_t(tbl.view(np.int32)), _t(rows))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_rowgather_onehot_twin_equals_jax_kernel(vmem_mod, seed):
    tbl, flat, _ = _words(seed)
    row = (flat >> 7).reshape(-1, 128)
    lane = (flat & 127).reshape(-1, 128)
    ref = pl.pallas_call(
        vmem_mod._rowgather_kernel,
        out_shape=jax.ShapeDtypeStruct(row.shape, jnp.uint32),
        in_specs=[pl.BlockSpec(memory_space=VMEM)] * 3,
        out_specs=pl.BlockSpec(memory_space=VMEM), interpret=True,
    )(jnp.asarray(tbl), jnp.asarray(row), jnp.asarray(lane))
    ref = np.asarray(ref)
    np.testing.assert_array_equal(ref, tbl.reshape(-1)[flat].reshape(
        row.shape))
    got = tvg.rowgather_onehot(_t(tbl.view(np.int32)), _t(row), _t(lane))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)


def _jax_tal(vmem_mod, tbl, rows):
    return np.asarray(pl.pallas_call(
        vmem_mod._tal_kernel,
        out_shape=jax.ShapeDtypeStruct(rows.shape, jnp.uint32),
        in_specs=[pl.BlockSpec(memory_space=VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=VMEM), interpret=True,
    )(jnp.asarray(tbl), jnp.asarray(rows)))


def _jax_rowgather(vmem_mod, tbl, row, lane):
    return np.asarray(pl.pallas_call(
        vmem_mod._rowgather_kernel,
        out_shape=jax.ShapeDtypeStruct(row.shape, jnp.uint32),
        in_specs=[pl.BlockSpec(memory_space=VMEM)] * 3,
        out_specs=pl.BlockSpec(memory_space=VMEM), interpret=True,
    )(jnp.asarray(tbl), jnp.asarray(row), jnp.asarray(lane)))


# rows at and past either end of the R-row table: -1, -R, -R/2 - 1 (from
# the end), -R - 1, R, R + 3 (outside), 0, R - 1; lanes -1, 128, 200, 127
EDGE_ROWS = tuple(tvg.edge_rows(R))
EDGE_LANES = tuple(tvg.EDGE_LANES)


def _edge_rows(case, rng, shape):
    """(E / 128, 128) rows of one case: every edge row in turn
    ("from the end": -1, -R, -R/2 - 1; "past either end": -R - 1, R,
    R + 3; "all edges" adds 0 and R - 1), or the edges mixed into a random
    draw."""
    edges = {"from the end": EDGE_ROWS[:3], "past either end": EDGE_ROWS[3:6],
             "all edges": EDGE_ROWS}.get(case)
    if edges is None:                                   # "mixed"
        rows = rng.integers(0, R, shape, dtype=np.int64).astype(np.int32)
        rows.flat[::3] = np.resize(np.array(EDGE_ROWS, np.int32),
                                   rows.flat[::3].shape)
        return rows
    return np.resize(np.array(edges, np.int32), shape)


@pytest.mark.parametrize("case", ["from the end", "past either end",
                                  "all edges", "mixed"])
def test_tal_sublane_twin_equals_jax_kernel_outside_the_table(vmem_mod,
                                                              case):
    """A row in [-R, 0) reads row R + r, a row outside [-R, R) gives
    0xFFFFFFFF (take_along_axis' fill for a u32 word): the twin's bits
    equal the JAX kernel's (interpret mode) on two 128-lane tiles."""
    rng = np.random.default_rng(len(case))
    tbl = rng.integers(0, 2**32, (R, 128), dtype=np.uint32)
    rows = _edge_rows(case, rng, (2, 128))
    ref = _jax_tal(vmem_mod, tbl, rows)
    got = tvg.tal_sublane(_t(tbl.view(np.int32)), _t(rows))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    back = (rows < 0) & (rows >= -R)
    outside = (rows < -R) | (rows >= R)
    lanes = np.broadcast_to(np.arange(128), rows.shape)
    assert (ref[outside] == 0xFFFFFFFF).all()
    np.testing.assert_array_equal(ref[back], tbl[rows[back] + R, lanes[back]])
    assert case == "mixed" or (back | outside).any()


@pytest.mark.parametrize("case", ["rows from the end", "rows past either end",
                                  "lanes outside", "mixed"])
def test_rowgather_onehot_twin_equals_jax_kernel_outside_the_table(
        vmem_mod, case):
    """A lane outside [0, 128) gives 0 whatever the row (the one-hot sum
    matches no lane); for a lane inside, a row in [-R, 0) reads row R + r
    and a row outside [-R, R) gives 0xFFFFFFFF: the twin's bits equal the
    JAX kernel's (interpret mode) on two 128-lane tiles."""
    rng = np.random.default_rng(10 + len(case))
    tbl = rng.integers(0, 2**32, (R, 128), dtype=np.uint32)
    shape = (2, 128)
    lane = rng.integers(0, 128, shape, dtype=np.int64).astype(np.int32)
    if case == "rows from the end":
        row = _edge_rows("from the end", rng, shape)
    elif case == "rows past either end":
        row = _edge_rows("past either end", rng, shape)
    elif case == "lanes outside":
        # each outside lane with in-range rows and with every edge row
        row = np.resize(np.array(EDGE_ROWS + (5,), np.int32), shape)
        lane = np.resize(np.repeat(np.array(EDGE_LANES, np.int32), 9), shape)
    else:
        row = _edge_rows("mixed", rng, shape)
        lane.flat[1::5] = np.resize(np.array(EDGE_LANES, np.int32),
                                    lane.flat[1::5].shape)
    ref = _jax_rowgather(vmem_mod, tbl, row, lane)
    got = tvg.rowgather_onehot(_t(tbl.view(np.int32)), _t(row), _t(lane))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    hit = (lane >= 0) & (lane < 128)
    outside = (row < -R) | (row >= R)
    assert (ref[~hit] == 0).all()
    assert (ref[hit & outside] == 0xFFFFFFFF).all()
    if case != "rows from the end":
        assert (~hit | outside).any()


def test_tal_sublane_picks_the_staged_kernel_by_rows_alone():
    """tal_sublane's staged kernel takes tables up to STAGED_MAX_ROWS
    rows (their 8-lane slices fit one block's 232,448 bytes of shared
    memory); one row more goes to tal_sublane_l2."""
    smem, m = 232_448, tvg.STAGED_MAX_ROWS
    assert m * 32 <= smem < (m + 1) * 32
    assert tvg.tal_kernel(1) == tvg.tal_kernel(m) == "tal_sublane"
    assert tvg.tal_kernel(m + 1) == "tal_sublane_l2"
    assert "tal_sublane_l2" in kernels.KERNELS


def test_edge_draw_mixes_every_edge_into_the_default_draw():
    """with_edges (the card tests' and chip_smoke.py's edge draw) keeps
    the table and puts every edge row and lane among random indices, and
    some edge lanes on edge rows."""
    x = tvg.make_inputs(128 * 6, R, "cpu", seed=4)
    e = tvg.with_edges(x, R)
    assert e["tbl"] is x["tbl"]
    for key in ("rows2d", "row"):
        vals = set(e[key].view(-1).tolist())
        assert set(tvg.edge_rows(R)) <= vals and len(vals) > 20
        assert torch.equal(e[key].view(-1)[1::3], x[key].view(-1)[1::3])
    lane = e["lane"].view(-1)
    assert set(tvg.EDGE_LANES) <= set(lane.tolist())
    both = (((lane < 0) | (lane >= 128))
            & ((e["row"].view(-1) < -R) | (e["row"].view(-1) >= R)))
    assert both.any()


def _rows(seed):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((T, 2)).astype(np.float32)
    idx = rng.integers(0, T, (M,)).astype(np.int32)
    idx[:64] = 7                                  # one row hit 64+ times
    vals = rng.standard_normal((M, 2)).astype(np.float32)
    return table, idx, vals


@pytest.mark.parametrize("seed", [0, 1])
def test_pallas_gather_twin_equals_jax_kernel(proto_kernels, seed):
    table, idx, _ = _rows(seed)
    ref = pl.pallas_call(
        proto_kernels[0],
        out_shape=jax.ShapeDtypeStruct((M, 2), jnp.float32),
        grid=(M // TILE,),
        in_specs=[pl.BlockSpec((T, 2), lambda i: (0, 0), memory_space=VMEM),
                  pl.BlockSpec((TILE,), lambda i: (i,), memory_space=VMEM)],
        out_specs=pl.BlockSpec((TILE, 2), lambda i: (i, 0),
                               memory_space=VMEM),
        interpret=True,
    )(jnp.asarray(table), jnp.asarray(idx))
    ref = np.asarray(ref)
    np.testing.assert_array_equal(ref.view(np.uint32),
                                  np.asarray(jnp.take(table, idx, axis=0))
                                  .view(np.uint32))
    got = tpg.pallas_gather(_t(table), _t(idx))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  ref.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 1])
def test_pallas_scatter_twin_within_order_bound_of_jax_kernel(
        proto_kernels, seed):
    _, idx, vals = _rows(seed)
    ref = pl.pallas_call(
        proto_kernels[1],
        out_shape=jax.ShapeDtypeStruct((T, 2), jnp.float32),
        grid=(M // TILE,),
        in_specs=[pl.BlockSpec((TILE,), lambda i: (i,), memory_space=VMEM),
                  pl.BlockSpec((TILE, 2), lambda i: (i, 0),
                               memory_space=VMEM)],
        out_specs=pl.BlockSpec((T, 2), lambda i: (0, 0), memory_space=VMEM),
        interpret=True,
    )(jnp.asarray(idx), jnp.asarray(vals))
    ref = np.asarray(ref)
    xla = np.asarray(jnp.zeros((T, 2), jnp.float32).at[idx].add(vals))
    got = tpg.pallas_scatter(_t(idx), _t(vals), T)
    bound = tpg.scatter_order_bound(_t(idx), _t(vals), T).numpy()
    assert bound.max() > 0
    for other in (ref, xla):
        assert (np.abs(got.numpy() - other) <= bound).all()


def test_plain_twins_take_rows_outside_the_table_as_the_kernels_do():
    """Indices past either end and in [-T, 0), as JAX's XLA calls take
    them: jnp.take and .at[].add count -T <= i < 0 from the end of the
    table, gather NaN for an index outside [-T, T) and drop its update.
    The CUDA kernels do the same (tests/test_torch_cuda.py)."""
    table, idx, vals = _rows(3)
    idx[::5] = T + 3
    idx[1::11] = -T - 2
    idx[2::13] = -1
    idx[3::17] = -T
    idx[4::19] = -(T // 2) - 1
    ref = np.asarray(jnp.zeros((T, 2), jnp.float32).at[idx].add(vals))
    got = tpg.pallas_scatter(_t(idx), _t(vals), T)
    bound = tpg.scatter_order_bound(_t(idx), _t(vals), T).numpy()
    assert (np.abs(got.numpy() - ref) <= bound).all()
    assert got[-1].ne(0).all() and got[0].ne(0).all()
    rows = tpg.pallas_gather(_t(table), _t(idx)).numpy()
    outside = (idx >= T) | (idx < -T)
    assert outside.any() and (idx == -1).any()
    assert np.isnan(rows[outside]).all() and not np.isnan(rows[~outside]).any()
    np.testing.assert_array_equal(
        rows, np.asarray(jnp.take(jnp.asarray(table), idx, axis=0)))
    assert (rows[idx == -1] == table[-1]).all()
    neg = np.array([-1, 0], dtype=np.int32)
    ones = np.ones((2, 2), np.float32)
    np.testing.assert_array_equal(
        tpg.pallas_scatter(_t(neg), _t(ones), T).numpy(),
        np.asarray(jnp.zeros((T, 2), jnp.float32).at[neg].add(ones)))
    np.testing.assert_array_equal(
        tpg.pallas_gather(_t(table), _t(neg)).numpy(),
        np.asarray(jnp.take(jnp.asarray(table), neg, axis=0)))


def test_gather_edge_draw_mixes_every_edge_and_twin_takes_it_as_jnp():
    """proto_pallas_gather.with_edges (kernel 9a's edge draw in the card
    tests and chip_smoke.py) keeps the table and vals and puts every edge
    row among the random indices; the twin gathers that draw as
    jnp.take(table, idx, axis=0) does, bit for bit (NaN outside
    [-T, T))."""
    x = tpg.make_inputs(T, M, "cpu")
    e = tpg.with_edges(x, T)
    assert e["table"] is x["table"] and e["vals"] is x["vals"]
    idx = e["idx"]
    assert set(tpg.edge_rows(T)) <= set(idx.tolist())
    assert len(set(idx[::3].tolist())) == len(tpg.edge_rows(T))
    for k in (1, 2):
        assert torch.equal(idx[k::3], x["idx"][k::3])
    got = tpg.pallas_gather(x["table"], idx).numpy()
    ref = np.asarray(jnp.take(jnp.asarray(x["table"].numpy()),
                              jnp.asarray(idx.numpy()), axis=0))
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    outside = (idx < -T) | (idx >= T)
    assert np.isnan(got[outside.numpy()]).all()
    assert not np.isnan(got[~outside.numpy()]).any()


def test_cpu_calls_launch_no_kernel():
    tbl, flat, rows = _words(2)
    table, idx, vals = _rows(2)
    before = {k: kernels.launches()[k] for k in NEW_KERNELS}
    tvg.tal_sublane(_t(tbl.view(np.int32)), _t(rows))
    tvg.rowgather_onehot(_t(tbl.view(np.int32)),
                         _t((flat >> 7).reshape(-1, 128)),
                         _t((flat & 127).reshape(-1, 128)))
    tpg.pallas_gather(_t(table), _t(idx))
    tpg.pallas_scatter(_t(idx), _t(vals), T)
    assert {k: kernels.launches()[k] for k in NEW_KERNELS} == before
    assert all(k in kernels.KERNELS for k in NEW_KERNELS)


def test_wrappers_reject_what_the_kernels_do_not_take():
    tbl = torch.zeros((R, 128), dtype=torch.int32)
    rows = torch.zeros((E // 128, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        tvg.tal_sublane(tbl.to(torch.int64), rows)
    with pytest.raises(ValueError):
        tvg.tal_sublane(tbl, rows.reshape(-1))        # E must tile by 128
    with pytest.raises(ValueError):
        tvg.rowgather_onehot(tbl, rows, rows[:1])
    with pytest.raises(ValueError):
        tvg.make_inputs(1000, R, "cpu")
    with pytest.raises(ValueError):
        tvg.tal_sublane(tbl[:0], rows)                # a table with no row
    table = torch.zeros((T, 2))
    idx = torch.zeros(M, dtype=torch.int32)
    with pytest.raises(ValueError):
        tpg.pallas_gather(table.double(), idx)
    with pytest.raises(ValueError):
        tpg.pallas_gather(torch.zeros((T, 3)), idx)
    with pytest.raises(ValueError):
        tpg.pallas_scatter(idx.long(), torch.zeros((M, 2)), T)
    with pytest.raises(ValueError):
        tpg.pallas_scatter(idx, torch.zeros((M - 1, 2)), T)
