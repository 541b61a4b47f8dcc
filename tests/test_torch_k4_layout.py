"""K4 in the model's layout, on the CPU: the plain versions on the strided
views ``ScOT``'s attention hands the kernel, against the contiguous call
and the JAX ``window_attention`` (its Pallas kernel in interpret mode, as
``test_torch_scot.py`` runs it) on float64 operands; and the wrapper's
layout check (``operand_strides``) as the pure function it is. The kernels
themselves run on a card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pregen_pde_tpu.ops.window_attention import window_attention as jax_window_attention
from pregen_pde_tpu_torch.ops import window_attention as twa

from torch_threads import _one_torch_thread  # noqa: F401 (autouse)

# float64 on both sides: the two differ by summation order only (~1e-16
# measured); the layout itself must change nothing but that
F64_TOL = 1e-12
# the JAX kernel forms its logits and products with float32 accumulation
# (preferred_element_type) even on float64 operands: 1.1e-6 measured
JAX_TOL = 1e-5


def _model_views(seed, nb, h, n, hd, nw, dtype=torch.float64):
    """q, k, v as ``WindowAttentionV2.forward`` passes them (the (nb, h, n,
    hd) views of (nb, n, h·hd) projections, q and k cosine-normalised, q at
    a logit scale of 10) and the bias as 16σ of an (n, n, h) table permuted
    to (h, n, n), plus a −100 mask at nw > 1."""
    rng = np.random.default_rng(seed)
    heads = lambda a: torch.from_numpy(a).to(dtype).reshape(nb, n, h, hd).permute(0, 2, 1, 3)
    q, k, v = (heads(rng.normal(size=(nb, n, h * hd))) for _ in range(3))
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-6) * 10.0
    k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-6)
    table = torch.from_numpy(rng.normal(size=(n, n, h))).to(dtype)
    bias = (16.0 * torch.sigmoid(table.permute(2, 0, 1)))[None]
    if nw > 1:
        mask = -100.0 * torch.from_numpy(rng.uniform(size=(nw, n, n)) > 0.7).to(dtype)
        bias = bias + mask[:, None]
    return q, k, v, bias


@pytest.mark.parametrize("nw", [1, 4], ids=["unshifted", "shifted"])
def test_k4_plain_on_model_views_matches_contiguous_and_pallas(nw):
    q, k, v, bias = _model_views(nw, nb=8, h=2, n=16, hd=8, nw=nw)
    assert not q.is_contiguous() and not bias.is_contiguous()  # the model's layouts
    contig = [t.contiguous() for t in (q, k, v, bias)]
    out = twa.window_attention_plain(q, k, v, bias)
    lse_out, lse = twa.window_attention_lse_plain(q, k, v, bias)
    ref_out, ref_lse = twa.window_attention_lse_plain(*contig)
    np.testing.assert_allclose(out.numpy(), ref_out.numpy(), rtol=F64_TOL, atol=F64_TOL)
    np.testing.assert_allclose(lse_out.numpy(), ref_out.numpy(), rtol=F64_TOL, atol=F64_TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), rtol=F64_TOL, atol=F64_TOL)
    jax_out = np.asarray(jax_window_attention(*(jnp.asarray(t.numpy()) for t in contig)))
    assert jax_out.dtype == np.float64
    np.testing.assert_allclose(out.numpy(), jax_out, rtol=JAX_TOL, atol=JAX_TOL)
    # the CPU wrapper runs the plain version on the views, launching nothing
    twa.reset_launches()
    got = twa.window_attention(q, k, v, bias)
    assert twa.launches == 0
    np.testing.assert_allclose(got.numpy(), out.numpy(), rtol=F64_TOL, atol=F64_TOL)


def test_k4_plain_lse_matches_logsumexp_of_pallas_logits():
    """The log-sum-exp the kernel saves is that of q kᵀ + bias, the logits of
    the JAX kernel, in float64."""
    q, k, v, bias = _model_views(7, nb=4, h=3, n=16, hd=8, nw=2)
    _, lse = twa.window_attention_lse_plain(q, k, v, bias)
    qn, kn, bn = (t.contiguous().numpy() for t in (q, k, bias))
    logits = np.einsum("bhnd,bhmd->bhnm", qn, kn).reshape(2, 2, 3, 16, 16) + bn[None]
    m = logits.max(-1, keepdims=True)
    ref = (m + np.log(np.exp(logits - m).sum(-1, keepdims=True)))[..., 0].reshape(4, 3, 16)
    np.testing.assert_allclose(lse.numpy(), ref, rtol=F64_TOL, atol=F64_TOL)


@pytest.mark.parametrize("nb,h,n,hd", [(3, 24, 16, 32), (64, 3, 256, 32), (16, 12, 64, 64)])
def test_operand_strides_accepts_the_model_views(nb, h, n, hd):
    """``heads(...)`` of a projection, and the same after the cosine norm
    and the logit scale, are read in place: strides (n·c, hd, c)."""
    c = h * hd
    x = torch.zeros(nb, n, c)
    q = x.reshape(nb, n, h, hd).permute(0, 2, 1, 3)
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-6
    scaled = q / norm * torch.ones(1, h, 1, 1)
    assert twa.operand_strides(q) == twa.operand_strides(scaled) == (n * c, hd, c)
    assert twa.operand_strides(torch.zeros(nb, h, n, hd)) == (h * n * hd, n * hd, hd)
    # the forward's own output buffer, (nb, n, h, hd) seen as (nb, h, n, hd)
    out = torch.empty_strided((nb, h, n, hd), (n * h * hd, hd, h * hd, 1))
    assert twa.operand_strides(out) == (n * c, hd, c)
    assert out.permute(0, 2, 1, 3).reshape(nb, n, c).data_ptr() == out.data_ptr()


def test_operand_strides_refuses_what_the_kernels_cannot_read():
    q = torch.zeros(2, 3, 16, 8)
    with pytest.raises(ValueError, match="last dim contiguous"):
        twa.operand_strides(q.transpose(-1, -2).contiguous().transpose(-1, -2))
    with pytest.raises(ValueError, match="float32"):
        twa.operand_strides(q.double())
    # rows off a 16-byte boundary: a storage offset of one float
    with pytest.raises(ValueError, match="16-byte aligned"):
        twa.operand_strides(torch.zeros(2 * 3 * 16 * 8 + 1)[1:].reshape(2, 3, 16, 8))
    # a token stride that is no multiple of 4 floats
    with pytest.raises(ValueError, match="16-byte aligned"):
        twa.operand_strides(torch.zeros(2, 3, 16, 10)[..., :8])
    # strides of dims of size 1 are never used
    one = torch.zeros(1, 1, 16, 8).as_strided((1, 1, 16, 8), (7, 3, 8, 1))
    assert twa.operand_strides(one) == (7, 3, 8)


def test_k4_argument_buffers_are_per_thread():
    """The wrapper packs a call's arguments into its thread's own buffers:
    two threads in K4 at once never launch with each other's arguments."""
    import threading

    seen = []
    both = threading.Barrier(2)

    def grab():
        seen.append((twa._bufs.fwd_addr, twa._bufs.bwd_addr))
        both.wait()  # both threads alive, so no buffer is freed and reused

    threads = [threading.Thread(target=grab) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    (f0, b0), (f1, b1) = seen
    assert len({f0, f1, b0, b1}) == 4
    assert (twa._bufs.fwd_addr, twa._bufs.bwd_addr) not in seen
