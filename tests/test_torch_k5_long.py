"""K5 past 8192 keys.

JAX's q-tiled forward (``vae_gslm_tpu/ops/flash_attention.py::_dispatch``)
has no key cap; 8192 is its blockwise backward's limit alone, past which
its custom VJP differentiates the XLA reference.  The port's K5 wrapper
takes any Tk on the card, and past 8192 keys ``FlashAttention`` and
``FlashAttentionPacked``'s off-envelope branch run K5 forward and then
the dense recomputed backward.

CPU: the wrapper's CUDA branch (the launch stubbed) takes Tk 9000 and
12288 and counts one launch; K5b keeps its limit; the routing.  Card
(``cuda``): K5 bfloat16 and float32 at Tk 12288 (self and Tq != Tk)
against the plain version, and ``FlashAttention`` at Tk 9000 against
autograd of the plain reference."""
import types

import pytest
import torch

from test_torch_flash_k5_bf16 import _hold
from vae_gslm_tpu_torch.nn.positions import alibi_slopes
from vae_gslm_tpu_torch.ops import flash_attention as fa

D = 64


def _on_card(shape):
    """A stand-in for a CUDA tensor: the wrapper reads only its device
    and shape before it launches."""
    return types.SimpleNamespace(device=types.SimpleNamespace(type="cuda"),
                                 shape=shape)


@pytest.mark.parametrize("tq,tk", [(9000, 9000), (128, 12288),
                                   (12288, 12288)])
def test_k5_launches_past_8192_keys(monkeypatch, tq, tk):
    """K5's CUDA branch launches for Tk past ``MAX_TK`` (it raised
    NotImplementedError there before), one count a call."""
    calls = []
    monkeypatch.setattr(fa, "_bhtd_launch",
                        lambda kind, *a: calls.append(kind) or "o")
    q, k = _on_card((1, 2, tq, D)), _on_card((1, 2, tk, D))
    before = fa.flash_forward_tiled.launches
    assert tk > fa.MAX_TK
    assert fa.flash_forward_tiled(q, k, k, None, None, True) == "o"
    assert calls == ["tiled"]
    assert fa.flash_forward_tiled.launches == before + 1
    # the dispatch of JAX's _dispatch sends it to K5 too
    assert fa.flash_attention(q, k, k, None, None, True) == "o"


def test_k5b_keeps_its_limit():
    """K5b's 8192 keys are JAX's real limit: past them it refuses, and
    the custom VJP routes to the dense recompute instead."""
    q, k = _on_card((1, 2, 16, D)), _on_card((1, 2, 9000, D))
    with pytest.raises(NotImplementedError, match="8192"):
        fa.flash_backward_blockwise(q, k, k, q, q, None, None, False)
    assert fa.backward_route(9000, 9000) == "dense"
    assert fa.backward_route(16, 9000) == "dense"
    assert fa.backward_route(1100, 8192) == "blockwise"


def test_k5_plans_do_not_grow_with_tk():
    """Neither K5 body sizes anything by Tk: one plan takes every call."""
    assert fa.k5_fwd_plan(64) == fa.k5_fwd_plan(64)
    assert fa.k5_grid(2, 16, 12288) == (16, 2, 96)
    assert fa.f32_fwd_grid(2, 16, 12288, 64) == (16, 2, 96)
    w = fa.k5_walks(0, 12288, 12288, 12288, False)
    assert w == (192, 192, 192)


# ----------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K5 on the card needs an NVIDIA GPU (sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, h, tq, tk, dtype, seed):
    g = torch.Generator(dev).manual_seed(seed)
    q = torch.randn((b, tq, h * D), generator=g, device=dev).to(dtype)
    kv = torch.randn((b, tk, 2 * h * D), generator=g, device=dev).to(dtype)
    qh = q.view(b, tq, h, D).transpose(1, 2)
    kh, vh = (x.view(b, tk, h, D).transpose(1, 2) for x in kv.chunk(2, -1))
    return qh, kh, vh


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tq,causal", [(12288, True), (256, False)])
def test_cuda_k5_at_12288_keys_matches_plain(cuda_device, dtype, tq,
                                             causal):
    dev = cuda_device
    b, h, tk = 2, 2, 12288
    q, k, v = _inputs(dev, b, h, tq, tk, dtype, tq)
    lengths = torch.tensor([tk, 9001], dtype=torch.int32, device=dev)
    slopes = -torch.tensor(alibi_slopes(h), device=dev)
    before = fa.flash_forward_tiled.launches
    got = fa.flash_forward_tiled(q, k, v, lengths, slopes, causal)
    torch.cuda.synchronize()
    assert fa.flash_forward_tiled.launches == before + 1
    want = torch.cat([fa.flash_forward_tiled_plain(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], lengths[i:i + 1], slopes,
        causal) for i in range(b)])
    if dtype == torch.bfloat16:
        _hold(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_flash_attention_at_9000_keys_takes_dense_grads(cuda_device):
    dev = cuda_device
    b, h, t = 1, 2, 9000
    q, k, v = (x.detach().clone().requires_grad_()
               for x in _inputs(dev, b, h, t, t, torch.float32, 3))
    lengths = torch.tensor([t - 7], dtype=torch.int32, device=dev)
    slopes = -torch.tensor(alibi_slopes(h), device=dev)
    g = torch.randn(q.shape, device=dev)
    fa.flash_attention_bhtd(q, k, v, lengths, slopes).backward(g)
    got = [x.grad for x in (q, k, v)]
    ins = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    fa.attention_reference(*ins, lengths, slopes, True).backward(g)
    for a, w in zip(got, (x.grad for x in ins)):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4)
