"""The port's dataflow verifier (``repro_torch.analysis.kernel_verify``):
every kernel and body clean at the audit's launches, each rule firing on a
block map a test has broken, corner sampling above 4,096 cells, the card
records' decoding and comparison, and the statement against the JAX
package's own capture of the same launches."""

import dataclasses
import itertools

import pytest
import torch

from repro_torch.analysis import audit, contracts
from repro_torch.analysis import kernel_verify as kv
from repro_torch.core import perf_model

LAUNCHES = audit.resolved_launches()


def _id(case):
    kind, shape, params, dtype, quant = case
    ptrs = "-".join(str(v % 16) for v in (params.get("ptrs") or {}).values())
    return (f"{kind}-{'x'.join(map(str, shape))}-{str(dtype)[6:]}-{quant}-"
            f"{params.get('body', '-')}-S{params.get('splits', 1)}-{ptrs}"
            f"{'-km' if params.get('kmajor') else ''}")


def test_every_kernel_and_body_is_swept():
    """The sweep reaches each kernel's every body (bf16 wgmma comes from
    the paths' recorded launches on the card: no sweep shape has n > 16
    with k and n multiples of 8)."""
    seen = {(k, p.get("body"), q == "int8") for k, _, p, _, q in LAUNCHES}
    for want in [("tsm2r", "simt", False), ("tsm2r", "skinny", False),
                 ("tsm2r", "simt", True), ("tsm2r", "skinny", True),
                 ("tsm2r", "wgmma", True), ("tsm2l", "stream", False),
                 ("tsm2l", "tile", False), ("tsm2l", "stream", True),
                 ("tsm2l", "tile", True), ("tsmt", "simt", False),
                 ("tsmt", "simt", True), ("tsmt", "packed", True),
                 ("reduce", None, False), ("quantize", None, False)]:
        assert want in seen, want
    splits = {(k, p.get("splits", 1) > 1, q) for k, _, p, _, q in LAUNCHES
              if k in ("tsm2r", "tsmt")}
    assert {("tsm2r", True, "none"), ("tsm2r", True, "int8"),
            ("tsmt", True, "none"), ("tsmt", True, "int8")} <= splits
    slices = [p for k, _, p, _, _ in LAUNCHES
              if k == "tsmt" and p["splits"] == 1 and p["slices"] > 1]
    assert slices, "no one-launch tsmt over slices in the sweep"


@pytest.mark.parametrize("case", LAUNCHES, ids=_id)
def test_audit_launches_are_clean(case):
    kind, shape, params, dtype, quant = case
    rep = kv.verify_kernel_config(kind, shape, params, dtype, quant=quant)
    assert list(rep) == []
    assert rep.blocks > 0


@pytest.mark.parametrize("shape,dtype", [
    ((8192, 4096, 256), torch.bfloat16), ((1000, 776, 200), torch.bfloat16),
    ((4096, 4096, 24), torch.bfloat16)])
def test_bf16_wgmma_body_is_clean(shape, dtype):
    p = perf_model.kernel_params("tsm2r", *shape, dtype, 1)
    assert p["body"] == "wgmma"
    assert list(kv.verify_kernel_config("tsm2r", shape, p, dtype)) == []


# ---------------------------------------------------------------------------
# Each rule caught on a broken map
# ---------------------------------------------------------------------------

def _split_tsm2r():
    shape = (4096, 4096, 16)
    p = perf_model.kernel_params("tsm2r", *shape, torch.float32, 4)
    return shape, p, kv.block_map("tsm2r", shape, p)


def _rules(vios):
    return {v.rule for v in vios}


def test_swapped_tiles_race():
    shape = (4096, 4096, 64)
    p = perf_model.kernel_params("tsm2r", *shape, torch.float32, 1)
    blocks = kv.block_map("tsm2r", shape, p)
    # block (0, 0) writes block (1, 0)'s tile, as a swapped index would
    a = next(b for b in blocks if b.block == (1, 0, 0))
    blocks = [dataclasses.replace(b, rows=a.rows)
              if b.block == (0, 0, 0) else b for b in blocks]
    rules = _rules(kv.check_blocks("tsm2r", shape, p, torch.float32, blocks))
    assert {"write-race", "coverage"} <= rules


@pytest.mark.parametrize("fault,rule", [
    ("overlap", "reduction-slices"), ("empty", "reduction-slices"),
    ("missing", "reduction-slices"), ("bounds", "index-bounds"),
    ("read-bounds", "index-bounds"), ("slot", "index-bounds"),
    ("f16", "accumulator-dtype"), ("int8-in-f32", "accumulator-dtype"),
    ("grid", "launch-meta-drift")])
def test_each_rule_caught_on_a_split_map(fault, rule):
    shape, p, blocks = _split_tsm2r()
    b0 = blocks[0]
    lo, hi = b0.red
    broken = {
        "overlap": dataclasses.replace(b0, red=(lo, hi + 32)),
        "empty": dataclasses.replace(b0, red=(lo, lo)),
        "missing": dataclasses.replace(b0, red=(lo + 32, hi)),
        "bounds": dataclasses.replace(b0, rows=(4000, 4128)),
        "read-bounds": dataclasses.replace(b0, red=(lo, 5000)),
        "slot": dataclasses.replace(b0, slot=4),
        "f16": dataclasses.replace(b0, acc=(2, 0)),
        "int8-in-f32": dataclasses.replace(b0, acc=(4, 1)),
        "grid": dataclasses.replace(b0, grid=(33, 1, 4)),
    }[fault]
    vios = kv.check_blocks("tsm2r", shape, p, torch.float32,
                           [broken, *blocks[1:]])
    assert rule in _rules(vios)


def test_int8_wants_exact_int32_tiles():
    shape = (4096, 4096, 16)
    p = perf_model.kernel_params("tsm2r", *shape, torch.int8, 1)
    blocks = kv.block_map("tsm2r", shape, p, torch.float32, quant="int8")
    assert {b.acc for b in blocks} == {(4, 1)}
    f32 = [dataclasses.replace(b, acc=(4, 0)) for b in blocks]
    assert "accumulator-dtype" in _rules(kv.check_blocks(
        "tsm2r", shape, p, torch.float32, f32, quant="int8"))


def _one_launch_tsmt():
    shape = (65536, 128, 4)
    p = perf_model.kernel_params("tsmt", *shape, torch.float32, 1)
    assert p["splits"] == 1 and p["slices"] > 1
    return shape, p, kv.block_map("tsmt", shape, p)


def test_one_launch_tsmt_finalizes_each_tile_once():
    shape, p, blocks = _one_launch_tsmt()
    finals = [b for b in blocks if b.final]
    tiles = contracts.launch_grid("tsmt", shape, p)
    assert len(finals) == tiles[0] * tiles[1]
    assert {b.ticket for b in finals} == {p["slices"] - 1}
    assert kv.check_blocks("tsmt", shape, p, torch.float32, blocks) == []


@pytest.mark.parametrize("fault", ["twice", "early", "never"])
def test_finalize_faults_caught(fault):
    shape, p, blocks = _one_launch_tsmt()
    f = next(b for b in blocks if b.final)
    rest = [b for b in blocks if b is not f]
    broken = {"twice": [f, f, *rest],
              "early": [dataclasses.replace(f, ticket=0), *rest],
              "never": rest}[fault]
    assert "finalize-once" in _rules(kv.check_blocks(
        "tsmt", shape, p, torch.float32, broken))


def test_recorded_grid_off_launch_grid_is_drift():
    shape, p, blocks = _split_tsm2r()
    g = contracts.launch_grid("tsm2r", shape, p)
    assert kv.check_blocks("tsm2r", shape, p, torch.float32, blocks,
                           recorded_grid=g) == []
    assert "launch-meta-drift" in _rules(kv.check_blocks(
        "tsm2r", shape, p, torch.float32, blocks,
        recorded_grid=(g[0] + 1, g[1], g[2])))


def test_quantize_chunks_cover_each_band():
    shape = (4100, 130, 256)
    blocks = kv.block_map("quantize", shape, {"kmajor": False})
    absmax = [b for b in blocks if b.buf == "amax"]
    broken = [b for b in blocks if b is not absmax[3]]
    rules = _rules(kv.check_blocks("quantize", shape, {"kmajor": False},
                                   torch.float32, broken))
    assert "reduction-slices" in rules


# ---------------------------------------------------------------------------
# Corner sampling
# ---------------------------------------------------------------------------

def test_sample_cells_corners():
    cells, sampled = kv.sample_cells((10, 3, 1))
    assert not sampled and len(cells) == 30
    cells, sampled = kv.sample_cells((1000, 10, 1))
    assert sampled
    assert {c[0] for c in cells} == {0, 1, 500, 998, 999}
    assert {c[1] for c in cells} == {0, 1, 5, 8, 9}


def test_corner_sampling_still_catches_a_swapped_tile(monkeypatch):
    shape = (1 << 20, 4096, 256)
    p = perf_model.kernel_params("tsm2r", *shape, torch.bfloat16, 1)
    grid = contracts.launch_grid("tsm2r", shape, p)
    assert grid[0] * grid[1] * grid[2] > kv.EXHAUSTIVE_CELL_LIMIT
    clean = kv.verify_kernel_config("tsm2r", shape, p, torch.bfloat16)
    assert clean.sampled and list(clean) == []
    orig = kv._MAPS["tsm2r"]

    def swapped(shape_, p_, dtype, cells, grid_):
        for b in orig(shape_, p_, dtype, cells, grid_):
            if b.block[0] == 1:   # block (1, j) writes block (0, j)'s rows
                b = dataclasses.replace(b, rows=(0, p_["tile"][0]))
            yield b

    monkeypatch.setitem(kv._MAPS, "tsm2r", swapped)
    rep = kv.verify_kernel_config("tsm2r", shape, p, torch.bfloat16)
    assert rep.sampled
    assert "write-race" in _rules(rep)


# ---------------------------------------------------------------------------
# The card's records: decoding and comparison
# ---------------------------------------------------------------------------

def _encode(blocks, bases):
    """Card records of ``blocks`` as block_map.cuh writes them."""
    rows = []
    for b in blocks:
        base, step, _ = bases[b.buf]
        dst = base + b.slot * step
        z = max(b.block[2], 0)
        rows.append([dst & 0xFFFFFFFF, dst >> 32, b.body, b.block[0],
                     b.block[1], z, *b.grid, *b.rows, *b.cols, *b.red,
                     *b.acc, int(b.final), b.ticket, b.tile])
    t = torch.tensor(rows, dtype=torch.int64)
    return torch.where(t >= 2**31, t - 2**32, t).to(torch.int32).reshape(-1)


def test_records_round_trip_through_from_records():
    shape, p, blocks = _one_launch_tsmt()
    bases = {"C": (0x7F0000001000, 0, 1),
             "P": (0x7F1000000000, 128 * 4 * 4, p["slices"])}
    card = kv.from_records(_encode(blocks, bases), bases)
    assert kv.compare(card, blocks) == []
    assert kv.check_blocks("tsmt", shape, p, torch.float32, card) == []


def test_compare_catches_a_record_off_the_statement():
    shape, p, blocks = _split_tsm2r()
    bases = {"P": (0x7F1000000000, 4096 * 16 * 4, 4)}
    card = kv.from_records(_encode(blocks, bases), bases)
    card[5] = dataclasses.replace(card[5], red=(0, 1))
    vios = kv.compare(card, blocks, "t")
    assert [v.rule for v in vios] == ["block-map-mismatch"]
    # a record into a buffer the launch does not own
    card = kv.from_records(_encode(blocks, bases),
                           {"P": (0x7F2000000000, 4096 * 16 * 4, 4)})
    assert {b.buf for b in card} == {"?"}


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------

PARITY = [("tsm2r", (4096, 4096, 16), 4, {"block_m": 512, "block_k": 256}),
          ("tsm2r", (2048, 2048, 8), 2, {"block_m": 256, "block_k": 512}),
          ("tsmt", (65536, 128, 4), 4, {"block_m": 512, "block_a": 128}),
          ("tsmt", (4096, 64, 8), 2, {"block_m": 256, "block_a": 64})]


@pytest.mark.parametrize("kind,shape,s,ref_blocks", PARITY,
                         ids=lambda v: str(v))
def test_partial_stack_and_writes_match_the_jax_package(kind, shape, s,
                                                        ref_blocks):
    import jax.numpy as jnp

    from repro.analysis import kernel_verify as jax_kv

    caps = jax_kv.capture_kernel(kind, shape, {**ref_blocks, "splits": s},
                                 jnp.float32)
    ref_partials = tuple(caps[0].out_shapes[0].shape)
    p = perf_model.kernel_params(kind, *shape, torch.float32, s)
    blocks = kv.block_map(kind, shape, p)
    slots = 1 + max(b.slot for b in blocks)
    rows = max(b.rows[1] for b in blocks)
    cols = max(b.cols[1] for b in blocks)
    assert (slots, rows, cols) == ref_partials
    # the sequential launch's writes cover C whole, once
    p1 = perf_model.kernel_params(kind, *shape, torch.float32, 1)
    seq = [b for b in kv.block_map(kind, shape, p1) if b.buf == "C"]
    area = sum((b.rows[1] - b.rows[0]) * (b.cols[1] - b.cols[0])
               for b in seq)
    m, d1, d2 = shape
    assert area == (d1 * d2 if kind == "tsmt" else m * d2)
    ref_seq = jax_kv.capture_kernel(kind, shape, {**ref_blocks, "splits": 1},
                                    jnp.float32)
    assert tuple(ref_seq[0].out_shapes[0].shape) == (
        (d1, d2) if kind == "tsmt" else (m, d2))
    assert kv.check_blocks(kind, shape, p1, torch.float32,
                           kv.block_map(kind, shape, p1)) == []


def test_reduce_epilogue_matches_the_jax_partials_sum():
    import jax.numpy as jnp

    from repro.analysis import kernel_verify as jax_kv

    s, rows, cols = 8, 4096, 16
    caps = jax_kv.capture_kernel("reduce", (s, rows, cols), {"block_r": 512},
                                 jnp.float32)
    assert tuple(caps[0].out_shapes[0].shape) == (rows, cols)
    grid, threads, vec, _ = perf_model.reduce_plan(s, rows, cols,
                                                   torch.float32)
    params = {"vec": vec, "threads": threads,
              "max_blocks": perf_model.REDUCE_BLOCKS_PER_SM * 132}
    blocks = kv.block_map("reduce", (s, rows, cols), params)
    assert sum(b.rows[1] - b.rows[0] for b in blocks) == rows * cols
    assert {b.red for b in blocks} == {(0, s)}
    assert {b.grid for b in blocks} == {tuple(grid)}


def test_verify_report_fields():
    shape, p, _ = _split_tsm2r()
    rep = kv.verify_kernel_config("tsm2r", shape, p)
    assert isinstance(rep, list) and not rep.sampled
    assert rep.grid == tuple(contracts.launch_grid("tsm2r", shape, p))
    assert rep.cells == rep.grid[0] * rep.grid[1] * rep.grid[2]
    with pytest.raises(ValueError, match="unknown kernel kind"):
        kv.block_map("gemm", shape, p)
    assert list(itertools.islice(kv.BODY_CODES.values(), 0, 3)) == [1, 2, 3]
