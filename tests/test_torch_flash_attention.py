"""The port's flash attention (K1, K2a, K2b) against the JAX package's.

On the CPU each wrapper runs its plain PyTorch version; these tests
hold it to the JAX package's Pallas kernels in interpreter mode, on the
same numpy inputs, at fp32 with atol = rtol = 1e-5 (both sides compute
in fp32; only the blocking and summation order differ), and on bf16
inputs where the bf16 casts of p and ds decide the result.  The CUDA
kernels are held to the plain versions on the card, in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

The JAX kernel module is imported inside each test: ``tests/
conftest.py`` refuses a module-level import of it in an unmarked test.
"""
import importlib

import numpy as np
import pytest
import torch

fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(L, seed=0, B=2, H=2, D=64):
    r = np.random.RandomState(seed)
    return [r.randn(B, L, H, D).astype(np.float32) for _ in range(4)]


def _cpu_launches():
    return (fa.flash_attention_fwd.launches, fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches)


@pytest.mark.parametrize("L,causal", [(32, False), (32, True), (4, True),
                                      (37, False)])
def test_forward_out_and_lse_match_pallas(L, causal):
    """K1's plain version: ``out`` and ``lse`` equal the Pallas forward,
    at lengths on and off the JAX block grid (4 and 37 are padded there,
    masked here)."""
    from autodist_tpu.ops.flash_attention import flash_attention_with_lse

    q, k, v, _ = _inputs(L)
    want_out, want_lse = flash_attention_with_lse(q, k, v, causal=causal)
    before = _cpu_launches()
    out, lse = fa.flash_attention_fwd(*map(torch.as_tensor, (q, k, v)),
                                      causal=causal)
    assert _cpu_launches() == before            # CPU: no kernel launch
    assert out.shape == (2, L, 2, 64) and lse.shape == (2, L, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


@pytest.mark.parametrize("L,causal", [(32, False), (37, True)])
def test_gradients_match_jax_grad(L, causal):
    """dq, dk, dv through ``torch.autograd`` (K2a and K2b's plain
    versions) against ``jax.grad`` of the Pallas kernel."""
    import jax
    import jax.numpy as jnp
    from autodist_tpu.ops.flash_attention import flash_attention

    q, k, v, g = _inputs(L, seed=1)
    want = jax.grad(lambda *a: jnp.sum(flash_attention(*a, causal=causal)
                                       * g), argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    (fa.flash_attention(tq, tk, tv, causal=causal)
     * torch.as_tensor(g)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _bf16(*xs):
    """The same numpy arrays rounded to bf16 on both sides."""
    import jax.numpy as jnp
    return ([jnp.asarray(x, jnp.bfloat16) for x in xs],
            [torch.as_tensor(x).bfloat16() for x in xs])


def _assert_bf16_matches(got, want):
    """bf16 results of the same computation: within 1e-5 except where a
    different summation order flips the rounding of one p or ds, which
    shifts one row of the result, at most 1 in 100 elements, and then
    within the bf16 tolerance (atol = rtol = 1e-2).  A bf16 cast of p or
    ds missing on either side moves about a third of them."""
    got = got.detach().float().numpy()
    want = np.asarray(want).astype(np.float32)
    off = np.abs(got - want) > 1e-5 + 1e-5 * np.abs(want)
    assert off.mean() <= 1e-2, f"{off.sum()} of {off.size} elements differ"
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_forward_and_gradients_match_pallas(causal):
    """bf16 inputs through K1 and, by autograd, K2a and K2b's plain
    versions against the Pallas kernels and ``jax.grad``.  At L = 32
    Pallas takes one key block, so both sides round the same p and ds
    to bf16 before the products."""
    import jax
    import jax.numpy as jnp
    from autodist_tpu.ops.flash_attention import (flash_attention,
                                                  flash_attention_with_lse)

    (jq, jk, jv, jg), (tq, tk, tv, tg) = _bf16(*_inputs(32, seed=4))
    want_out, want_lse = flash_attention_with_lse(jq, jk, jv, causal=causal)
    want = jax.grad(lambda *a: jnp.sum(
        flash_attention(*a, causal=causal).astype(jnp.float32)
        * jg.astype(jnp.float32)), argnums=(0, 1, 2))(jq, jk, jv)
    for t in (tq, tk, tv):
        t.requires_grad_()
    out, lse = fa.flash_attention_with_lse(tq, tk, tv, causal=causal)
    (out.float() * tg.float()).sum().backward()
    assert out.dtype == tq.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(want_lse),
                               **TOL)
    for got, ref in zip((out, tq.grad, tk.grad, tv.grad),
                        (want_out,) + tuple(want)):
        _assert_bf16_matches(got, ref)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_backward_fp32_gradients_match_pallas(causal):
    """K2a and K2b's plain versions on bf16 inputs return fp32 dq, dk
    and dv equal to the Pallas backward's before its cast back, at the
    fp32 tolerance, given the Pallas forward's ``out`` and ``lse``."""
    import jax.numpy as jnp
    jfa = importlib.import_module("autodist_tpu.ops.flash_attention")

    B, L, H, D = 2, 32, 2, 64
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _bf16(*_inputs(L, seed=5))
    bhld = lambda x: jnp.moveaxis(x, 2, 1).reshape(B * H, L, D)  # noqa: E731
    scale = 1.0 / np.sqrt(D)
    args = [bhld(x) for x in (jq, jk, jv)]
    out, lse = jfa._flash_fwd_2d(*args, scale, causal, L, L, True, L)
    want = jfa._flash_bwd(*args, out, lse, bhld(jg), scale, causal, L, L,
                          True, L)
    out = torch.tensor(np.asarray(out.astype(jnp.float32))).bfloat16()
    out = out.reshape(B, H, L, D).transpose(1, 2)
    lse = torch.tensor(np.asarray(lse)).reshape(B, H, L).transpose(1, 2)
    delta = (tg.float() * out.float()).sum(-1)
    kw = dict(lse=lse.contiguous(), delta=delta, causal=causal)
    dq = fa.flash_attention_bwd_dq(tq, tk, tv, tg, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(tq, tk, tv, tg, **kw)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == torch.float32
        ref = np.asarray(ref).reshape(B, H, L, D).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_lse_cotangent_folds_into_delta():
    """``flash_attention_with_lse`` differentiates through ``lse`` too:
    its cotangent folds into delta as ``delta - g_lse``, as in the JAX
    kernel's backward (the ring-attention merge needs it)."""
    import jax
    import jax.numpy as jnp
    from autodist_tpu.ops.flash_attention import flash_attention_with_lse

    q, k, v, g = _inputs(40, seed=2)
    g_lse = np.random.RandomState(3).randn(2, 40, 2).astype(np.float32)

    def objective(*a):
        out, lse = flash_attention_with_lse(*a)
        return jnp.sum(out * g) + jnp.sum(lse * g_lse)

    want = jax.grad(objective, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out, lse = fa.flash_attention_with_lse(tq, tk, tv)
    ((out * torch.as_tensor(g)).sum()
     + (lse * torch.as_tensor(g_lse)).sum()).backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("causal,mask,dropout,error",
                         [(False, True, False, "padding masks"),
                          (True, False, True, "attention dropout"),
                          (False, False, True, "attention dropout")])
def test_make_attention_fn_rejects_what_the_kernel_cannot_do(causal, mask,
                                                             dropout, error):
    """Both packages' adapters refuse a padding mask without
    ``causal=True`` and any attention dropout, before any kernel runs."""
    from autodist_tpu.ops.flash_attention import \
        make_attention_fn as jax_make_attention_fn

    q, k, v, _ = _inputs(8)
    jmask = np.ones((2, 1, 1, 8), bool) if mask else None
    with pytest.raises(ValueError, match=error):
        jax_make_attention_fn(causal)(q, k, v, jmask,
                                      object() if dropout else None)
    fn = fa.make_attention_fn(causal)
    assert fa.is_flash_attention_fn(fn) and fn.causal == causal
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    with pytest.raises(ValueError, match=error):
        fn(tq, tk, tv, torch.as_tensor(jmask) if mask else None,
           torch.Generator() if dropout else None)


def test_causal_adapter_takes_the_model_mask_as_the_triangle():
    q, k, v, _ = map(torch.as_tensor, _inputs(8))
    mask = torch.ones(8, 8, dtype=torch.bool).tril()[None, None]
    torch.testing.assert_close(fa.make_attention_fn(True)(q, k, v, mask, None),
                               fa.flash_attention(q, k, v, causal=True))
    assert not fa.is_flash_attention_fn(fa.flash_attention_with_lse)


@pytest.mark.parametrize("bad", ["shape", "rank", "stats"])
def test_wrappers_check_shapes_before_anything_runs(bad):
    q, k, v, g = map(torch.as_tensor, _inputs(8))
    lse = torch.zeros(2, 8, 2)
    if bad == "shape":
        with pytest.raises(ValueError, match="self-attention"):
            fa.flash_attention_fwd(q, k[:, :4], v)
    elif bad == "rank":
        with pytest.raises(ValueError, match=r"\[B, L, H, D\]"):
            fa.flash_attention_fwd(q[0], k[0], v[0])
    else:
        with pytest.raises(ValueError, match="delta"):
            fa.flash_attention_bwd_dq(q, k, v, g, lse, lse[:, :4])
