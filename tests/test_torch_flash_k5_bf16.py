"""K5's bfloat16 forward (``fwd_stream_wgmma`` in
``csrc/flash_attention.cu``: K streamed twice through a TMA ring, two
consumer warpgroups of 64 query rows sharing each K/V tile, wgmma
products): its launch plan and walks on the CPU, and on a card the
kernel against its plain version.  Torch only (no JAX), so the card's
machine runs it as it is.

CPU: the plan fits an H100 block's 232,448 bytes and is the one every
launch takes, Tk 8192 included; the blocks cover every (query row, head,
batch) once, the longest causal walks first; each warpgroup's walk
covers every key that can hold a probability of its rows (Tq != Tk,
causal and not, rows of length 0 and 1); the kernel's numerics (two
passes, p = ex2((x - m) log2 e) times 1/l rounded to bf16, float32 P.V)
emulated in torch hold the card's bf16 gate against the plain version at
Tk 8192.  Card (``cuda``): T 1100, 1536, 1750 and 8192 causal, Tq 96 x
Tk 256 non-causal, lengths 0 and 1, ALiBi on and off, one launch a call,
at ``chip_smoke.py``'s gate: max |diff| <= 1e-2 max|ref|, element by
element 2 bf16 ulps + 1e-2 rms(ref), relative L2 1e-3."""
import math
import types

import numpy as np
import pytest
import torch

from vae_gslm_tpu_torch.nn.positions import alibi_slopes
from vae_gslm_tpu_torch.ops import flash_attention as fa

D = 64
TILE = 64


class _FakeLib:
    """Records the arguments of ``flash_fwd_tiled_launch``."""

    def __init__(self):
        self.calls = []

    def flash_fwd_tiled_launch(self, *args):
        self.calls.append(args)
        return 0


def _fake_launch(monkeypatch) -> _FakeLib:
    """A recording library in place of the kernels and a stand-in for
    the caller's CUDA stream, so a launch's arguments are read on the
    CPU."""
    lib = _FakeLib()
    monkeypatch.setattr(fa, "_launchers", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return lib


@pytest.mark.parametrize("tq,tk", [(1750, 1750), (96, 256), (37, 8192),
                                   (8192, 8192), (1, 1)])
def test_k5_plan_holds_every_launch(monkeypatch, tq, tk):
    """The plan fits the block limit, is the kernel's sum, and is what a
    bf16 K5 launch passes (smem bytes, query rows per block, stages)
    whatever Tq and Tk: every walk streams, so nothing grows with them."""
    plan = fa.k5_fwd_plan(64)
    tile_bytes = TILE * D * 2
    assert plan.bytes <= fa.SMEM_LIMIT
    assert plan.bytes == 1024 + (2 + 2 * plan.stages) * tile_bytes \
        + 8 * (1 + 2 * plan.stages)
    assert plan.q_rows == 2 * TILE and plan.stages >= 2
    lib = _fake_launch(monkeypatch)
    h = 2
    q = torch.zeros((1, tq, h * D), dtype=torch.bfloat16)
    kv = torch.zeros((1, tk, 2 * h * D), dtype=torch.bfloat16)
    qh = q.view(1, tq, h, D).transpose(1, 2)
    kh, vh = (x.view(1, tk, h, D).transpose(1, 2) for x in kv.chunk(2, -1))
    lengths = torch.tensor([tk], dtype=torch.int32)
    o = fa._bhtd_launch("tiled", qh, kh, vh, lengths, None, True)
    assert o.shape == qh.shape and o.dtype == torch.bfloat16
    (args,) = lib.calls
    assert args[-4:] == (plan.bytes, plan.q_rows, plan.stages, 0)
    assert args[-7:-4] == (1, 1, 1.0 / math.sqrt(D))   # bf16, causal, scale


def test_k5_rejects_misaligned_views(monkeypatch):
    """The tensor maps need 16-byte aligned bases and strides: a bf16
    view one element off raises before any launch."""
    lib = _fake_launch(monkeypatch)
    base = torch.zeros(1 + 2 * 70 * 3 * 128, dtype=torch.bfloat16)[1:]
    x = base.view(2, 70, 3 * 128)
    q, k, v = (x[..., 128 * i:128 * (i + 1)].view(2, 70, 2, D)
               .transpose(1, 2) for i in range(3))
    lengths = torch.tensor([70, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        fa._bhtd_launch("tiled", q, k, v, lengths, None, True)
    assert lib.calls == []


@pytest.mark.parametrize("t", [64, 200, 1750, 8192])
def test_k5_grid_runs_the_longest_walks_first(t):
    """Block z of the grid holds query block nz - 1 - z; the blocks cover
    every query row once, and on causal rows of full length the ring's
    walks never grow along the launch order."""
    gx, gy, gz = fa.k5_grid(2, 3, t)
    assert (gx, gy) == (3, 2) and gz * 128 >= t > (gz - 1) * 128
    order = [gz - 1 - z for z in range(gz)]
    rows = sorted(r for qb in order for r in range(128 * qb,
                                                   min(128 * qb + 128, t)))
    assert rows == list(range(t))
    walks = [fa.k5_walks(qb, t, t, t, True)[2] for qb in order]
    assert walks == sorted(walks, reverse=True)
    assert walks[0] == -(-t // TILE)


@pytest.mark.parametrize("tq,tk,causal", [
    (1750, 1750, True), (96, 256, False), (96, 256, True), (256, 96, True),
    (37, 300, True), (300, 37, False), (130, 8192, False),
    (1100, 1100, True), (129, 129, True)])
def test_k5_walks_cover_every_probability(tq, tk, causal):
    """Each warpgroup's key walk reaches the last key any of its rows
    below Tq can weigh (below its length, at or before the row when
    causal; every key for a row of length 0), and the ring's walk is the
    longer of the two."""
    for length in (0, 1, 63, 64, 65, tk // 2, tk - 1, tk):
        for qb in range(-(-tq // 128)):
            w0, w1, ring = fa.k5_walks(qb, tq, length, tk, causal)
            assert ring == max(w0, w1)
            for wg, walk in enumerate((w0, w1)):
                rows = range(128 * qb + 64 * wg,
                             min(128 * qb + 64 * wg + 64, tq))
                if not rows:
                    assert walk == 0
                    continue
                last = -1
                for r in rows:
                    if length < 1:
                        last = tk - 1
                    else:
                        top = min(length, tk) - 1
                        last = max(last, min(top, r) if causal else top)
                # the walk ends with the tile of the last needed key
                assert walk == last // TILE + 1, (qb, wg, length)


def _emulate(q, k, v, lengths, slopes, causal):
    """The streaming kernel's arithmetic in float32 torch on bf16 (B, H,
    Tq, D) operands: pass 1 takes m and l online over 64-key tiles (ex2
    of (x - m) log2 e, l rescaled as m grows); pass 2 forms p = ex2((x -
    m) log2 e) x (1 / l), rounds it to bf16 and sums P.V in float32; o in
    bf16."""
    s, _ = fa._logits(q, k, lengths, slopes, causal)
    tk = k.shape[2]
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    m = torch.full(s.shape[:-1] + (1,), -math.inf)
    l = torch.zeros_like(m)
    for k0 in range(0, tk, TILE):
        x = s[..., k0:k0 + TILE]
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        l = l * torch.exp2((m - m_new) * log2e) + torch.exp2(
            (x - m_new) * log2e).sum(-1, keepdim=True)
        m = m_new
    inv = 1.0 / l
    p = (torch.exp2((s - m) * log2e) * inv).to(torch.bfloat16).float()
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(torch.bfloat16)


def _hold(got, want, tol=1e-2):
    """``chip_smoke.py``'s bf16 gate: max |diff| <= tol max|ref|, element
    by element 2 bf16 ulps + tol rms(ref), relative L2 1e-3."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    assert diff.max().item() <= tol * want.abs().max().item()
    _, e = torch.frexp(want)
    ulp = torch.where(want == 0, torch.zeros_like(want),
                      torch.ldexp(torch.ones_like(want), e - 8))
    excess = (diff - 2 * ulp).clamp_min(0).max().item()
    assert excess <= tol * want.pow(2).mean().sqrt().item(), excess
    assert diff.norm() <= 1e-3 * want.norm()


@pytest.mark.parametrize("causal", [True, False])
def test_k5_numerics_hold_the_gate_at_8192_keys(causal):
    """The emulated kernel against the plain version (exp(s - m) / l in
    float32 before the bf16 rounding of p) over 8192 keys, ALiBi on and
    off, lengths 8192, 0 and 1: within the card's bf16 gate."""
    rng = np.random.RandomState(7)
    b, h, tq, tk = 3, 1, 40, 8192
    q, k, v = (torch.from_numpy(rng.randn(b, h, t, D).astype(np.float32))
               .to(torch.bfloat16) for t in (tq, tk, tk))
    lengths = torch.tensor([tk, 0, 1], dtype=torch.int32)
    for sl in (-torch.tensor(alibi_slopes(8)[-1:]), None):
        got = _emulate(q, k, v, lengths, sl, causal)
        want = fa.flash_forward_tiled_plain(q, k, v, lengths, sl, causal)
        _hold(got, want)


# ----------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K5's bf16 forward needs an NVIDIA GPU (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (b, h, tq, tk, causal, lengths)
CARD_CASES = {
    "t1100": (3, 3, 1100, 1100, True, [1100, 1, 0]),
    "t1536": (2, 4, 1536, 1536, True, [1536, 1]),
    "t1750": (4, 3, 1750, 1750, True, [1750, 0, 1, 900]),
    "t8192": (3, 2, 8192, 8192, True, [8192, 0, 1]),
    "cross_96x256": (3, 4, 96, 256, False, [256, 0, 131]),
    "cross_96x8192": (3, 2, 96, 8192, False, [8192, 0, 1]),
    "causal_37x300": (3, 2, 37, 300, True, [300, 0, 1]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
@pytest.mark.parametrize("alibi", [True, False])
def test_cuda_k5_bf16_matches_plain(cuda_device, case, alibi):
    """``k5_fwd_wgmma_kernel`` against the plain version (one batch row
    at a time) from strided views of packed projections, one launch a
    call, at the bf16 gate."""
    b, h, tq, tk, causal, lens = CARD_CASES[case]
    dev = cuda_device
    g = torch.Generator(dev).manual_seed(tq + tk)
    xq = torch.randn((b, tq, h * D), generator=g, device=dev)
    xkv = torch.randn((b, tk, 2 * h * D), generator=g, device=dev)
    q = xq.to(torch.bfloat16).view(b, tq, h, D).transpose(1, 2)
    k, v = (x.view(b, tk, h, D).transpose(1, 2)
            for x in xkv.to(torch.bfloat16).chunk(2, dim=-1))
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    slopes = -torch.tensor(alibi_slopes(h), device=dev) if alibi else None
    before = fa.flash_forward_tiled.launches
    got = fa.flash_forward_tiled(q, k, v, lengths, slopes, causal)
    torch.cuda.synchronize()
    assert fa.flash_forward_tiled.launches == before + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    want = torch.cat([fa.flash_forward_tiled_plain(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], lengths[i:i + 1], slopes,
        causal) for i in range(b)])
    _hold(got, want)
