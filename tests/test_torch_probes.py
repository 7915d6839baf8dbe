"""The probe tool's twins (kernels P1-P4 of ``sdfgenfast_tpu_torch.tools.
micro_bench``) against the TPU probes' own bodies.

The bodies of ``tools/micro_bench.py`` (``:62-73``, ``:93-109``, ``:129-130``
and ``:150-151``) are closures at fixed sizes, so they are restated here
exactly, with the chain length as a parameter, and run through
``pl.pallas_call(..., interpret=True)`` on a small grid. XLA's CPU compiler
fuses ``a * b + c`` into one FMA inside those bodies (even with jit
disabled), so:

- P3 (``x * 2``) and P4 (``x + 1``) are compared bit for bit;
- P1 at the tool's 512 steps overflows to non-finite values everywhere, as
  on the TPU: bit for bit (NaN compared as NaN) for both variants;
- P1's FMA variant matches the fused body to 1 ulp (measured: bit for bit)
  on short chains whose values stay finite;
- P1 without FMA and P2 round every product and sum on their own, so on
  finite values they are held to the body with a relative tolerance: 1e-6
  for one P1 step (two multiply-adds, each at most one rounding apart), and
  1e-6 for P2's 256 steps on positive inputs (``a*b + 1 >= 1`` cannot
  cancel, so each fused step is within an ulp and the running minimum keeps
  the largest relative error of one step);
- both are bit for bit equal to a NumPy float32 restatement that rounds
  every operation, which is what the CUDA kernels (built ``--fmad=false``)
  compute.

On the card ``chip_smoke.py`` holds each kernel against these twins."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sdfgenfast_tpu_torch.tools import micro_bench as mb

torch.set_num_threads(1)

SUB, LANES, NB = 8, 128, 3


def _call(kernel, x, sub=SUB, lanes=LANES):
    nb = x.shape[0] // sub
    return np.asarray(pl.pallas_call(
        kernel,
        grid=(nb,),
        in_specs=[pl.BlockSpec((sub, lanes), lambda b: (b, 0))],
        out_specs=pl.BlockSpec((sub, lanes), lambda b: (b, 0)),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True,
    )(jnp.asarray(x)))


def _peak_kernel(CHAIN):
    def kernel(x_ref, o_ref):
        a = x_ref[:]
        b = a * 1.000001 + 0.5

        def body(i, carry):
            a, b = carry
            a = a * b + 1.0
            b = b * a + 0.5
            return a, b

        a, b = jax.lax.fori_loop(0, CHAIN, body, (a, b))
        o_ref[:] = a + b
    return kernel


def _mixed_kernel(CHAIN):
    def kernel(x_ref, o_ref):
        a = x_ref[:]
        b = a + 0.25
        best = a * 0.0 + 3e18

        def body(i, carry):
            a, b, best = carry
            d = a * b + 1.0         # fma
            d = d * d               # mul
            m = d < best            # cmp
            best = jnp.where(m, d, best)  # select
            a = a + 0.125
            b = b * 0.999
            return a, b, best

        a, b, best = jax.lax.fori_loop(0, CHAIN, body, (a, b, best))
        o_ref[:] = best
    return kernel


def _scale2_kernel(x_ref, o_ref):
    o_ref[:] = x_ref[:] * 2.0


def _add1_kernel(x_ref, o_ref):
    o_ref[:] = x_ref[:] + 1.0


def _x(lo=-1.5, hi=1.5, seed=0, shape=(SUB * NB, LANES)):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _bits_equal(a, b):
    """Bit for bit, every NaN counted equal to every NaN."""
    same = a.view(np.int32) == b.view(np.int32)
    return bool((same | (np.isnan(a) & np.isnan(b))).all())


def _np_peak(x, chain):
    """P1 without FMA in NumPy float32, every operation rounded."""
    f = np.float32
    a = x.copy()
    b = a * f(1.000001) + f(0.5)
    with np.errstate(over="ignore", invalid="ignore"):
        for _ in range(chain):
            a = a * b + f(1.0)
            b = b * a + f(0.5)
        return a + b


def _np_mixed(x, chain):
    f = np.float32
    a = x.copy()
    b = a + f(0.25)
    best = a * f(0.0) + f(3e18)
    for _ in range(chain):
        d = a * b + f(1.0)
        d = d * d
        best = np.where(d < best, d, best)
        a = a + f(0.125)
        b = b * f(0.999)
    return best


@pytest.mark.parametrize("fma", [False, True])
def test_vpu_peak_at_the_tools_chain_matches_the_pallas_body(fma):
    x = _x()
    want = _call(_peak_kernel(mb.PEAK_CHAIN), x)
    got = mb.vpu_peak(torch.from_numpy(x), mb.PEAK_CHAIN, fma=fma).numpy()
    assert not np.isfinite(want).any()  # the chain overflows, as on the TPU
    assert _bits_equal(got, want)


@pytest.mark.parametrize("chain", [1, 3, 8])
def test_vpu_peak_fma_matches_the_fused_pallas_body(chain):
    x = _x(seed=chain)
    want = _call(_peak_kernel(chain), x)
    got = mb.vpu_peak(torch.from_numpy(x), chain, fma=True).numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert fin.mean() > 0.1
    # ulp distance on finite values (both of one sign where they agree)
    ulps = np.abs(got[fin].view(np.int32).astype(np.int64)
                  - want[fin].view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


@pytest.mark.parametrize("chain", [1, 3, 8])
def test_vpu_peak_rounds_every_operation(chain):
    x = _x(seed=chain)
    got = mb.vpu_peak(torch.from_numpy(x), chain).numpy()
    assert _bits_equal(got, _np_peak(x, chain))
    if chain == 1:
        want = _call(_peak_kernel(chain), x)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_vpu_mixed_matches_the_pallas_body():
    x = _x(0.5, 1.5)
    want = _call(_mixed_kernel(mb.MIXED_CHAIN), x)
    got = mb.vpu_mixed(torch.from_numpy(x), mb.MIXED_CHAIN).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert _bits_equal(got, _np_mixed(x, mb.MIXED_CHAIN))


def test_vpu_mixed_rounds_every_operation_on_mixed_signs():
    x = _x(seed=4)
    got = mb.vpu_mixed(torch.from_numpy(x), mb.MIXED_CHAIN).numpy()
    assert _bits_equal(got, _np_mixed(x, mb.MIXED_CHAIN))


@pytest.mark.parametrize("n_blocks,rows", [(40, 128), (5, 1024)])
def test_grid_overhead_matches_the_pallas_body(n_blocks, rows):
    x = _x(seed=rows, shape=(n_blocks * rows, mb.GRID_COLS))
    x[0, :4] = [np.inf, -np.inf, np.nan, 3e38]
    want = _call(_scale2_kernel, x, sub=rows, lanes=mb.GRID_COLS)
    got = mb.grid_overhead(torch.from_numpy(x), n_blocks).numpy()
    assert _bits_equal(got, want)


def test_hbm_stream_matches_the_pallas_body():
    x = _x(seed=7, shape=(512 * 2, 512))
    x[0, :3] = [np.inf, np.nan, -0.0]
    want = _call(_add1_kernel, x, sub=512, lanes=512)
    got = mb.hbm_stream(torch.from_numpy(x)).numpy()
    assert _bits_equal(got, want)


def test_wrappers_validate_their_input():
    x = torch.ones((4, 48))
    with pytest.raises(ValueError, match="float32"):
        mb.hbm_stream(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        mb.vpu_peak(x.T)
    with pytest.raises(ValueError, match="blocks"):
        mb.grid_overhead(x, 5)


def test_the_tool_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mb.main()
    with pytest.raises(ValueError, match="CUDA"):
        mb.run(torch.device("cpu"))


# -- P3 and P4's work split and ring walks (csrc/probes.cu) -------------------
#
# P3 and P4 are one kernel, tile_kernel (x * 2 or x + 1): CTA b owns a tile
# of the array. The launchers' arguments come from micro_bench's plain
# functions (grid_plan and the HBM_TILE constant) and a CTA's cut of its
# tile is stated by tile_pieces: every float must be covered exactly once,
# by a bulk-copied chunk or by a scalar head or tail. The kernel's ring is
# transcribed below (_tile_cta), stepping through the same stage indices,
# barrier parities, chunk bounds and tails as the CUDA code, against a
# model of the mbarriers and of bulk copies that complete in an order a
# scheduler picks (loads write their stage and stores read theirs only
# when they complete). Every schedule must finish without a deadlock, write
# every float once, and give the twin's bits.

P3_CASES = [  # (blocks, block floats, lead: floats past a 16-byte boundary)
    (1, 6144, 0), (40, 128 * mb.GRID_COLS, 0), (5, 1024 * mb.GRID_COLS, 0),
    (7, 6143, 0), (3, 49151, 0), (5, 1, 0), (9, 3, 1), (10, 6144, 1),
    (11, 6143, 2), (5, 49152, 3), (4, 49151, 1), (2, 8193, 2),
]
P4_SIZES = [1, 3, 4, 17, mb.HBM_TILE - 1, mb.HBM_TILE, mb.HBM_TILE + 1,
            3 * mb.HBM_TILE + 23]


def _tiles_exactly(pieces, n):
    """The (kind, start, length) pieces tile [0, n) with no gap or overlap."""
    at = 0
    for _, start, length in sorted(pieces, key=lambda p: p[1]):
        assert start == at and length > 0
        at += length
    assert at == n


def _check_own(own, b, n, tile, lead, chunk):
    """CTA b's pieces lie in its tile; chunks are whole, aligned float4s."""
    assert all(b * tile <= s and s + k <= min((b + 1) * tile, n)
               for _, s, k in own)
    for kind, start, length in own:
        if kind == "chunk":  # 16-byte aligned, whole float4s
            assert (lead + start) % 4 == 0 and length % 4 == 0
            assert length <= chunk
        else:
            assert length <= 3


@pytest.mark.parametrize("n_blocks,bf,lead", P3_CASES)
def test_p3_split_covers_every_float_once(n_blocks, bf, lead):
    _, chunk = mb.grid_plan(bf)
    n = n_blocks * bf
    pieces = [p for b in range(n_blocks)
              for p in mb.tile_pieces(b, n, bf, lead, chunk)]
    _tiles_exactly(pieces, n)
    for b in range(n_blocks):
        own = mb.tile_pieces(b, n, bf, lead, chunk)
        _check_own(own, b, n, bf, lead, chunk)
        # a tile of up to GRID_ONE_CHUNK floats is one chunk
        assert bf > mb.GRID_ONE_CHUNK or len(
            [p for p in own if p[0] == "chunk"]) <= 1


@pytest.mark.parametrize("n", [0] + P4_SIZES + [int(np.prod(mb.HBM_SHAPE))])
def test_p4_split_covers_every_float_once(n):
    tile = mb.HBM_TILE
    grid = -(-n // tile)
    own = [mb.tile_pieces(b, n, tile, 0, tile) for b in range(grid)]
    _tiles_exactly([p for ps in own for p in ps], n)
    for b, ps in enumerate(own):
        _check_own(ps, b, n, tile, 0, tile)
        # one stage: a tile's body is one bulk copy; only the last tile is
        # ragged, and only it may end in a scalar tail
        assert [p[0] for p in ps] in (["chunk"], ["chunk", "tail"], ["tail"])
        assert b == grid - 1 or ps == [("chunk", b * tile, tile)]
    tails = [p for ps in own for p in ps if p[0] == "tail"]
    assert tails == ([("tail", n // 4 * 4, n % 4)] if n % 4 else [])


def test_p3_split_takes_unaligned_starts_and_odd_block_floats():
    for bf in (6143, 49151, 5):
        _, chunk = mb.grid_plan(bf)
        for lead in range(4):
            for b in range(3):
                own = mb.tile_pieces(b, 3 * bf, bf, lead, chunk)
                assert sum(k for _, _, k in own) == bf
                head = [p for p in own if p[0] == "head"]
                want = (4 - (lead + b * bf) % 4) % 4
                assert sum(k for _, _, k in head) == min(want, bf)
    assert mb.grid_plan(6143) == (1, 6140)
    assert mb.grid_plan(5) == (1, 4)
    assert mb.grid_plan(49151) == mb.GRID_RING


def test_tile_plans_fit_the_kernel():
    """The tool's launches are ones tile_kernel takes: a ring of at most
    MAX_STAGES stages of whole float4s below a barrier's 2^20 bytes, one
    stage holding a whole body, at most 227 KB of shared memory a CTA."""
    plans = [mb.grid_plan(rows * mb.GRID_COLS) for _, rows in mb.GRID_CASES]
    assert plans == [(1, 128 * mb.GRID_COLS), mb.GRID_RING]
    plans.append((1, mb.HBM_TILE))
    for stages, chunk in plans:
        assert 1 <= stages <= mb.MAX_STAGES and chunk % 4 == 0
        assert 4 * chunk <= mb.MAX_STAGE_BYTES
        assert mb.BAR_BYTES + 4 * stages * chunk <= 227 * 1024
    assert mb.GRID_RING[0] >= 2  # larger tiles load ahead of their stores
    assert mb.GRID_CTAS_PER_SM >= 1 and mb.HBM_CTAS_PER_SM >= 1
    assert mb.grid_overhead(torch.ones((0, mb.GRID_COLS)), 5).shape == (
        0, mb.GRID_COLS)


class _MBar:
    """An mbarrier: `count` arrivals and the expected transaction bytes
    complete a phase; a wait on parity p passes once the phase of parity p
    has completed (the current phase's parity differs from p)."""

    def __init__(self, count=1):
        self.count, self.left, self.tx, self.phase = count, count, 0, 0

    def arrive(self, tx=0):
        self.left -= 1
        self.tx += tx
        self._step()

    def complete_tx(self, nbytes):
        self.tx -= nbytes
        self._step()

    def _step(self):
        if self.left == 0 and self.tx == 0:
            self.phase, self.left = self.phase + 1, self.count

    def passed(self, parity):
        return (self.phase & 1) != parity


class _Bulk:
    """A CTA's bulk copies in flight: loads into a stage that complete on a
    barrier, and committed store groups that read their stage when they
    complete."""

    def __init__(self, out, writes):
        self.out, self.writes = out, writes
        self.loads, self.stores, self.groups = [], [], 0

    def load(self, dst, src, bar):
        self.loads.append((dst, src.clone(), bar))

    def store(self, start, src):
        self.stores.append((start, src, self.groups))
        self.groups += 1

    def read(self, pending):
        """wait_group.read `pending`: every group but the newest `pending`
        has read its source."""
        return all(g >= self.groups - pending for *_, g in self.stores)

    def complete(self, rng):
        if self.loads and (not self.stores or rng.random() < 0.5):
            dst, src, bar = self.loads.pop(int(rng.integers(len(self.loads))))
            dst.copy_(src)
            bar.complete_tx(4 * src.numel())
        else:
            start, src, _ = self.stores.pop(
                int(rng.integers(len(self.stores))))
            flat = src.reshape(-1)
            self.out[start:start + flat.numel()] = flat
            self.writes[start:start + flat.numel()] += 1


def _schedule(ctas, policy, seed):
    """Run CTAs, each (roles, bulk): step the roles (generators yielding
    the condition they wait on) and complete bulk copies. "threads" runs
    the threads as far as they go and completes copies only when every
    thread waits, "copies" completes every copy as soon as it is issued,
    "random" picks at random."""
    rng = np.random.default_rng(seed)
    waits = {role: None for roles, _ in ctas for role in roles}
    for role in waits:
        waits[role] = next(role, None)
    bulks = [bulk for _, bulk in ctas]
    while True:
        live = [r for r, w in waits.items() if w is not None]
        ready = [r for r in live if waits[r]()]
        pending = [b for b in bulks if b.loads or b.stores]
        if not live and not pending:
            return
        assert ready or pending, "deadlock: every thread waits, no copy left"
        run_thread = ready and (policy == "threads" or not pending or (
            policy == "random" and rng.random() < 0.5))
        if run_thread:
            role = ready[int(rng.integers(len(ready)))]
            waits[role] = next(role, None)
        else:
            pending[int(rng.integers(len(pending)))].complete(rng)


def _tile_cta(b, x, out, bulk, lead, tile, stages, chunk, op):
    """tile_kernel's CTA b over x's floats in tiles of `tile`: thread 0's
    loads and stores and every thread's waits, `op` (x * 2 or x + 1) and
    barriers, in the kernel's order."""
    base = b * tile
    size = min(tile, x.numel() - base)
    head = min((4 - (lead + base) % 4) % 4, size)
    body = (size - head) // 4 * 4
    tail = size - head - body
    nch = -(-body // chunk)
    full = [_MBar(1) for _ in range(stages)]
    ring = torch.full((stages, chunk), float("nan"))

    def load(c):
        s, k = c % stages, min(chunk, body - c * chunk)
        full[s].arrive(tx=4 * k)
        at = base + head + c * chunk
        # a bulk copy moves whole 16-byte words between aligned addresses
        assert (lead + at) % 4 == 0 and k % 4 == 0
        bulk.load(ring[s, :k], x[at:at + k], full[s])

    for c in range(min(stages, nch)):
        load(c)
    for start, k in ((base, head), (base + head + body, tail)):
        out[start:start + k] = op(x[start:start + k])
        bulk.writes[start:start + k] += 1
    for c in range(nch):
        s, k = c % stages, min(chunk, body - c * chunk)
        yield lambda: full[s].passed((c // stages) & 1)
        ring[s, :k] = op(ring[s, :k])
        bulk.store(base + head + c * chunk, ring[s, :k])
        nxt = c + stages - 1
        if c >= 1 and nxt < nch:
            yield lambda: bulk.read(1)
            load(nxt)
    yield lambda: bulk.read(0)


def _run_tiles(x, tile, lead, stages, chunk, op, policy, seed):
    """Every CTA of a launch over `x` under `policy`; returns the output
    and how often each float was written."""
    out = torch.full_like(x, float("nan"))
    writes = torch.zeros(x.numel(), dtype=torch.int32)
    ctas = []
    for b in range(-(-x.numel() // tile)):
        bulk = _Bulk(out, writes)
        ctas.append(([_tile_cta(b, x, out, bulk, lead, tile, stages, chunk,
                                op)], bulk))
    _schedule(ctas, policy, seed)
    return out, writes


def _seeded_flat(n, lead, seed):
    buf = _x(seed=seed, shape=(n + lead,)).ravel()
    buf[lead:lead + 4] = [np.inf, -np.inf, np.nan, -0.0][:max(0, min(4, n))]
    return torch.from_numpy(buf[lead:].copy())


POLICIES = ["threads", "copies", "random"]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("n_blocks,bf,lead,ring", [
    (2, 6144, 0, None), (3, 6143, 1, None), (2, 49152, 0, None),
    (2, 49151, 3, None), (5, 1, 0, None), (9, 3, 1, None),
    (5, 203, 2, (3, 16)), (4, 64, 0, (2, 4)), (3, 1000, 1, (3, 100)),
    (3, 1000, 2, (1, 1000)),
])
def test_p3_ring_walk_bit_equal_to_twin(n_blocks, bf, lead, ring, policy):
    """The tool's rings (None: grid_plan's) and others of 1, 2 and 3
    stages."""
    x = _seeded_flat(n_blocks * bf, lead, seed=bf)
    stages, chunk = ring or mb.grid_plan(bf)
    out, writes = _run_tiles(x, bf, lead, stages, chunk, lambda v: v * 2.0,
                             policy, seed=bf)
    assert bool((writes == 1).all())
    want = mb.grid_overhead(x, n_blocks).numpy()
    assert _bits_equal(out.numpy(), want)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("ring", [None, (3, 8)])
@pytest.mark.parametrize("n,tile", [
    (1, 64), (3, 64), (4, 64), (17, 64), (63, 64), (64, 64), (65, 64),
    (3 * 64 + 23, 64), (7 * 24 + 2, 24),
    (mb.HBM_TILE + 1, mb.HBM_TILE), (2 * mb.HBM_TILE + 7, mb.HBM_TILE),
])
def test_p4_ring_walk_bit_equal_to_twin(n, tile, ring, policy):
    """P4's launch (None: one stage of a whole tile, as hbm_stream) and the
    same kernel through a ring of 3 stages, on tiles whose last one is
    ragged and ends in a scalar tail."""
    stages, chunk = ring or (1, tile)
    x = _seeded_flat(n, 0, seed=n)
    out, writes = _run_tiles(x, tile, 0, stages, chunk, lambda v: v + 1.0,
                             policy, seed=n)
    assert bool((writes == 1).all())
    assert _bits_equal(out.numpy(), mb.hbm_stream(x).numpy())
