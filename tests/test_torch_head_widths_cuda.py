"""The flash family (K3-K5b, bf16 and float32) and K6 at head widths 32
and 128 on the card, against their plain versions.  Torch only (no JAX),
so the card's machine runs it as it is:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_head_widths_cuda.py -m cuda

Every body is a template on the head width (``csrc/flash_attention.cu``,
``csrc/flash_decode.cu``).  The gates are ``chip_smoke.py``'s D = 64
ones: float32 o and lse to 1e-5 x max(1, max|ref|), float32 gradients to
1e-4 x max|ref|; bf16 o to 1e-2 x max|ref| and gradients to 2e-2, each
also element by element (2 bf16 ulps + tol x rms(ref)) and in relative
L2 (1e-3), bf16 lse to 1e-5 x max(1, max|ref|); K6 to 1e-5 x max|ref|.
K5b's bf16 gradients at 1750 frames take ``chip_smoke.py``'s
``hold_flips``: an element past the element-wise limit passes only where
the kernel is within the bf16 rounding bound of the float64 gradient
(``grad_bounds``; a ds rounding flip: at D = 128 with ALiBi one dk
element sits 0.0243 rms past 2 ulps).  Here they skip, with their
reason."""
import pytest
import torch

from chip_smoke import grad_bounds, hold_flips
from vae_gslm_tpu_torch.nn.positions import alibi_slopes
from vae_gslm_tpu_torch.ops import flash_attention as fa
from vae_gslm_tpu_torch.ops import flash_decode as fd

WIDTHS = (32, 128)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the flash kernels at head widths 32 and 128 need an "
                    "NVIDIA GPU (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def hold(got, want, tol, floor=0.0, elementwise=False):
    """max |diff| <= tol x max(floor, max|ref|) and, with
    ``elementwise`` (a bf16 output other than lse), |diff| <= 2 bf16
    ulps + tol x rms(ref) element by element and ||diff|| <= 1e-3
    ||ref||."""
    assert got.shape == want.shape
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    assert diff.max().item() <= tol * max(floor, want.abs().max().item())
    if elementwise:
        _, e = torch.frexp(want)
        ulp = torch.where(want == 0, torch.zeros_like(want),
                          torch.ldexp(torch.ones_like(want), e - 8))
        assert (diff <= 2 * ulp + tol * want.pow(2).mean().sqrt()).all()
        assert diff.norm() <= 1e-3 * want.norm()


def _slopes(h, dev, alibi):
    return -torch.tensor(alibi_slopes(h), device=dev) if alibi else None


def _heads(d):
    """Heads of the packed calls: one 128-lane group at D = 32, two
    heads at D = 128."""
    return 4 if d == 32 else 2


# (T, lengths) of the packed K3/K3b calls; at D = 128 T 1000 and 1024
# are past the resident plan (K streamed through K5's body, lse written)
K3_CASES = [(200, [200, 77, 1, 130]), (640, [640, 0, 1, 323]),
            (1000, [1000, 0, 1, 611]), (1024, [1024, 1, 0, 700])]


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("case", range(len(K3_CASES)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("alibi", [True, False])
def test_cuda_k3_k3b_match_plain(cuda_device, d, case, dtype, alibi):
    dev = cuda_device
    t, lens = K3_CASES[case]
    b, h = len(lens), _heads(d)
    gen = torch.Generator(dev).manual_seed(t + d)
    qkv = torch.randn((b, t, 3 * h * d), generator=gen, device=dev).to(dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    go = torch.randn((b, t, h * d), generator=gen, device=dev).to(dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    sl = _slopes(h, dev, alibi)
    bf16 = dtype == torch.bfloat16
    n3, n3b = fa.flash_forward_packed.launches, fa.flash_backward_packed.launches
    o, lse = fa.flash_forward_packed(q, k, v, lengths, sl, True, h)
    o_ref, lse_ref = fa.flash_forward_packed_plain(q, k, v, lengths, sl,
                                                   True, h)
    grads = fa.flash_backward_packed(q, k, v, o, go, lse, lengths, sl, True,
                                     h)
    refs = fa.flash_backward_packed_plain(q, k, v, o, go, lse, lengths, sl,
                                          True, h)
    torch.cuda.synchronize()
    assert fa.flash_forward_packed.launches == n3 + 1
    assert fa.flash_backward_packed.launches == n3b + 1
    hold(o, o_ref, 1e-2 if bf16 else 1e-5, 0.0 if bf16 else 1.0, bf16)
    hold(lse, lse_ref, 1e-5, 1.0)
    for got, want in zip(grads, refs):
        hold(got, want, 2e-2 if bf16 else 1e-4, 0.0, bf16)


# (Tq, Tk, heads, lengths, causal, backward) of the (B, H, T, D) calls:
# K4 with lse and K4b at T <= 1024 (3 heads of 32: no packed grouping),
# K5 and K5b past it and across (Tq 96 x Tk 256 non-causal) at the D = 64
# card tests' and the long-segment step's shapes and at the scoring
# path's 1750 frames (backward "flips": held by ``hold_flips``)
BHTD_CASES = {"k4_300": (300, 300, 3, [300, 0, 1], True, True),
              "k4_300_nc": (300, 300, 3, [300, 1, 0], False, True),
              "k4_1024": (1024, 1024, 2, [1024, 0, 1], True, True),
              "k5_1100": (1100, 1100, 2, [1100, 1, 0], True, True),
              "k5_1536": (1536, 1536, 2, [1536, 1], True, True),
              "k5_1750": (1750, 1750, 2, [1750, 0, 1], True, "flips"),
              "k5_cross": (96, 256, 3, [256, 0, 1], False, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("case", list(BHTD_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("alibi", [True, False])
def test_cuda_bhtd_forward_backward_match_plain(cuda_device, d, case, dtype,
                                                alibi):
    """K4 (o, lse) then K4b, or K5 then K5b, from strided views of packed
    projections."""
    dev = cuda_device
    tq, tk, h, lens, causal, backward = BHTD_CASES[case]
    b = len(lens)
    gen = torch.Generator(dev).manual_seed(tq + d)
    xq = torch.randn((b, tq, 2 * h * d), generator=gen, device=dev)
    xkv = torch.randn((b, tk, 2 * h * d), generator=gen, device=dev)
    q, go = (x.view(b, tq, h, d).transpose(1, 2)
             for x in xq.to(dtype).chunk(2, dim=-1))
    k, v = (x.view(b, tk, h, d).transpose(1, 2)
            for x in xkv.to(dtype).chunk(2, dim=-1))
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    sl = _slopes(h, dev, alibi)
    bf16 = dtype == torch.bfloat16
    if fa.backward_route(tq, tk) == "full":
        o, lse = fa.flash_forward_full(q, k, v, lengths, sl, causal,
                                       with_stats=True)
        o_ref, lse_ref = fa.flash_forward_full_plain(q, k, v, lengths, sl,
                                                     causal, True)
        hold(lse, lse_ref, 1e-5, 1.0)
        fn, plain, extra = (fa.flash_backward_full,
                            fa.flash_backward_full_plain, (lse,))
    else:
        o = fa.flash_forward_tiled(q, k, v, lengths, sl, causal)
        o_ref = fa.flash_forward_tiled_plain(q, k, v, lengths, sl, causal)
        fn, plain, extra = (fa.flash_backward_blockwise,
                            fa.flash_backward_blockwise_plain, ())
    hold(o, o_ref, 1e-2 if bf16 else 1e-5, 0.0 if bf16 else 1.0, bf16)
    if not backward:
        return
    before = fn.launches
    got = fn(q, k, v, o, go, *extra, lengths, sl, causal)
    want = plain(q, k, v, o, go, *extra, lengths, sl, causal)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    if backward == "flips" and bf16:
        exact, bounds = grad_bounds(q, k, v, o, go, *(extra or (None,)),
                                    lengths, sl, causal)
        for name, a, w, x, bd in zip(("dq", "dk", "dv"), got, want, exact,
                                     bounds):
            hold_flips(case, name, a, w, x, bd, 2e-2)
        return
    for a, w in zip(got, want):
        hold(a, w, 2e-2 if bf16 else 1e-4, 0.0, bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_k5_past_8192_keys(cuda_device, d, dtype):
    """K5 at Tq 96 against Tk 9000 (lengths 9000, 0, 1), non-causal."""
    dev = cuda_device
    b, h, tq, tk = 3, 2, 96, 9000
    gen = torch.Generator(dev).manual_seed(d)
    q = torch.randn((b, h, tq, d), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((b, h, tk, d), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    lengths = torch.tensor([tk, 0, 1], dtype=torch.int32, device=dev)
    sl = _slopes(h, dev, True)
    bf16 = dtype == torch.bfloat16
    o = fa.flash_forward_tiled(q, k, v, lengths, sl, False)
    o_ref = fa.flash_forward_tiled_plain(q, k, v, lengths, sl, False)
    torch.cuda.synchronize()
    hold(o, o_ref, 1e-2 if bf16 else 1e-5, 0.0 if bf16 else 1.0, bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDTHS)
def test_cuda_k6_matches_plain(cuda_device, d):
    """K6 over an int8 head-major cache of 768 positions at positions
    across the 256-key block edges, a bf16 q as a view of one qkv
    projection, to 1e-5 x max|ref| (float32, both summing in 256-key
    blocks)."""
    dev = cuda_device
    b, h, t = 4, 1024 // d // 4, 768
    gen = torch.Generator(dev).manual_seed(d)
    qkv = torch.randn((b, 3 * h * d), generator=gen, device=dev).to(
        torch.bfloat16)
    q = qkv[:, :h * d].view(b, h, d)
    k, v = (torch.randint(-127, 128, (b, h, t, d), generator=gen,
                          device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((b, h, t), generator=gen, device=dev) * 0.02
              for _ in range(2))
    sl = _slopes(h, dev, True)
    for pos in (0, 255, 256, 511, 512, 767):
        before = fd.flash_decode_int8.launches
        got = fd.flash_decode_int8(q, k, v, ks, vs, pos, sl)
        want = fd.flash_decode_int8_plain(q, k, v, ks, vs, pos, sl)
        torch.cuda.synchronize()
        assert fd.flash_decode_int8.launches == before + 1
        hold(got, want, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 256])
def test_cuda_other_widths_raise(cuda_device, d):
    """No kernel quietly gives way to its plain version: any width
    outside {32, 64, 128} raises on the card, naming the widths."""
    dev = cuda_device
    h, t = 128 // d if d < 128 else 2, 64   # a packed grouping, as JAX's
    x = torch.zeros((1, t, h * d), device=dev, dtype=torch.bfloat16)
    lengths = torch.tensor([t], dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="32, 64 or 128"):
        fa.flash_forward_packed(x, x, x, lengths, None, True, h)
    k8 = torch.zeros((1, h, 256, d), dtype=torch.int8, device=dev)
    sc = torch.zeros((1, h, 256), device=dev)
    with pytest.raises(NotImplementedError, match="32, 64 or 128"):
        fd.flash_decode_int8(torch.zeros((1, h, d), device=dev), k8, k8, sc,
                             sc, 0, torch.zeros(h, device=dev))
