"""K3 (the quantized ring hop) and K4 (the collective-matmul hop), their
rings and the tensor-parallel boundaries, against the JAX package.

The port's plain versions (what the wrappers run on CPU tensors) are
held to the Pallas kernels in interpret mode: K3 bit for bit (levels
and scale), K4 within 1e-6 (fp32, other summation order).  The rings
run on gloo ranks in subprocesses, every rank's inputs made with numpy
in this process and saved for the workers, and are held to the JAX
package's host mirror of the ring bit for bit and to its ``shard_map``
programs on CPU devices.  The multi-rank results are computed once per
module.
"""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from autodist_tpu_torch import testing
from autodist_tpu_torch.kernel import collective_matmul as cm
from autodist_tpu_torch.kernel import quant_ring as qr
from autodist_tpu_torch.kernel import quantize as qz
RING_SIZES = (37, 64, 8, 4099)          # 37 and 4099 do not divide 2 or 4
# (x shape, kernel shape, axes, x model dim, kernel model dim): the JAX
# goldens' cases, the last the attention out projection with 7 % 2 != 0.
MATMUL_CASES = (((4, 6), (6, 10), 1, 1, 0), ((4, 6), (6, 16), 1, 1, 0),
                ((4, 2, 4), (2, 4, 7), 2, 1, 0))


def _hop_inputs(C, *, scale_in, zero_local=False, seed=0):
    r = np.random.RandomState(seed + C)
    q_in = r.randint(-127, 128, (1, C)).astype(np.int8)
    local = (np.zeros((1, C), np.float32) if zero_local
             else (3 * r.randn(1, C)).astype(np.float32))
    return q_in, np.float32(scale_in), local


@pytest.mark.parametrize("C", [1, 7, 1000, 4099])
@pytest.mark.parametrize("zero_local", [False, True])
def test_hop_plain_is_bit_exact_with_pallas(C, zero_local):
    """``fused_hop_plain`` against ``_fused_hop(..., interpret=True)`` at
    the opening quantize (scale_in 0), on random and all-zero chunks:
    every int8 level and the fp32 scale bit for bit."""
    from autodist_tpu.kernel.pallas.quant_ring import _fused_hop

    q_in, s_in, local = _hop_inputs(C, scale_in=0.0, zero_local=zero_local)
    q_in = np.zeros_like(q_in)
    jq, js = _fused_hop(jnp.asarray(q_in), jnp.asarray(s_in),
                        jnp.asarray(local), interpret=True)
    before = qr.fused_hop.launches
    tq, ts = qr.fused_hop(torch.as_tensor(q_in), torch.tensor([s_in]),
                          torch.as_tensor(local))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
    assert qr.fused_hop.launches == before     # the plain version ran


@pytest.mark.parametrize("C", [1, 7, 1000, 4099])
def test_hop_with_an_incoming_chunk(C):
    """A hop with ``scale_in != 0``: the port rounds ``f32(q) * s`` and
    ``+ local`` separately, as the JAX package's host mirror of the ring
    does (bit for bit).  Under ``jit`` XLA's CPU backend contracts the
    Pallas kernel's ``q * s + local`` into one FMA, so the interpreted
    hop may differ there by one rounding of ``acc``: the scale by at
    most 1 ulp, a level by at most 1."""
    from autodist_tpu.kernel.pallas.quant_ring import _fused_hop

    q_in, s_in, local = _hop_inputs(C, scale_in=0.0173)
    tq, ts = qr.fused_hop(torch.as_tensor(q_in), torch.tensor([s_in]),
                          torch.as_tensor(local))
    acc = jnp.asarray(q_in).astype(jnp.float32) * s_in
    acc = acc + jnp.asarray(local)                 # eager: two roundings
    scale = jnp.maximum(jnp.max(jnp.abs(acc)) / 127.0, 1e-20)
    mirror = jnp.clip(jnp.round(acc / scale), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(mirror))
    assert ts.numpy().tobytes() == np.asarray(scale).tobytes()
    jq, js = _fused_hop(jnp.asarray(q_in), jnp.asarray(s_in),
                        jnp.asarray(local), interpret=True)
    ulps = abs(int(ts.numpy().view(np.int32)) - int(
        np.asarray(js, np.float32).view(np.int32)))
    assert ulps <= 1
    assert np.abs(tq.numpy().astype(int) - np.asarray(jq).astype(int)
                  ).max() <= 1


@pytest.mark.parametrize("C", [1, 7, 1000])
@pytest.mark.parametrize("scale_in", [0.0, 0.0173])
def test_hop_plain_on_a_nan_is_bit_exact_with_pallas(C, scale_in):
    """A NaN in ``local``: ``fused_hop_plain`` and ``_fused_hop(...,
    interpret=True)`` both give a NaN scale, and equal levels (every
    quotient is NaN, and a NaN level is 0), at the opening quantize and
    on a hop."""
    from autodist_tpu.kernel.pallas.quant_ring import _fused_hop

    q_in, s_in, local = _hop_inputs(C, scale_in=scale_in)
    local[0, C // 2] = np.nan
    jq, js = _fused_hop(jnp.asarray(q_in), jnp.asarray(s_in),
                        jnp.asarray(local), interpret=True)
    tq, ts = qr.fused_hop_plain(torch.as_tensor(q_in), torch.tensor(s_in),
                                torch.as_tensor(local))
    assert np.isnan(float(js)) and torch.isnan(ts)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tq.numpy(), np.zeros_like(q_in))


def test_quantize_helpers_match_jax():
    """abs_max_scale, quantize_levels, quantize_int8 and dequantize_int8
    bit for bit against the JAX package's, ties included."""
    from autodist_tpu.kernel import quantize as jqz

    r = np.random.RandomState(3)
    x = (r.randn(4099) * 5).astype(np.float32)
    x[:4] = [0.5, 1.5, -2.5, 0.0]              # exact halves at scale 1
    for arr in (x, np.zeros(9, np.float32)):
        jq, js = jqz.quantize_int8(jnp.asarray(arr))
        tq, ts = qz.quantize_int8(torch.as_tensor(arr))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.numpy().tobytes() == np.asarray(js).tobytes()
        np.testing.assert_array_equal(
            qz.dequantize_int8(tq, ts).numpy(),
            np.asarray(jqz.dequantize_int8(jq, js)))
    one = torch.ones(())
    np.testing.assert_array_equal(
        qz.quantize_levels(torch.as_tensor(x[:4]), one).numpy(),
        np.asarray(jqz.quantize_levels(jnp.asarray(x[:4]), 1.0)))


def test_reference_ring_matches_jax_reference():
    from autodist_tpu.kernel.pallas.quant_ring import \
        reference_ring_all_reduce as jref

    for n, size in ((2, 37), (4, 64), (3, 10)):
        xs = np.random.RandomState(size).randn(n, size).astype(np.float32)
        for got, want in zip(qr.reference_ring_all_reduce(list(xs)),
                             jref(list(xs))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_matmul_plain_matches_pallas():
    """``fused_matmul_add_plain`` against ``_fused_matmul_add(...,
    interpret=True)`` at fp32 within 1e-6, a column slice of a wider
    ``k`` included.  ``x`` is scaled by ``1 / sqrt(K)`` so that the
    outputs are of order 1 and the two summation orders stay within the
    tolerance."""
    from autodist_tpu.kernel.pallas.collective_matmul import \
        _fused_matmul_add

    r = np.random.RandomState(0)
    for M, K, C in ((4, 6, 5), (100, 72, 40), (1, 1, 1)):
        carry = r.randn(M, C).astype(np.float32)
        x = (r.randn(M, K) / np.sqrt(K)).astype(np.float32)
        wide = r.randn(K, 2 * C).astype(np.float32)
        want = _fused_matmul_add(jnp.asarray(carry), jnp.asarray(x),
                                 jnp.asarray(wide[:, C:]), interpret=True)
        got = cm.fused_matmul_add(torch.as_tensor(carry), torch.as_tensor(x),
                                  torch.as_tensor(wide)[:, C:])
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-6)


def test_wrappers_refuse_mismatched_shapes():
    with pytest.raises(ValueError, match="differ in shape"):
        qr.fused_hop(torch.zeros(3, dtype=torch.int8), torch.zeros(1),
                     torch.zeros(4))
    with pytest.raises(ValueError, match="chain"):
        cm.fused_matmul_add(torch.zeros(2, 3), torch.zeros(2, 4),
                            torch.zeros(5, 3))


# --------------------------------------------------------------------------- #
# The rings on gloo ranks
# --------------------------------------------------------------------------- #
_WORKER = textwrap.dedent("""
    import sys
    import torch
    import autodist_tpu_torch as port
    from autodist_tpu_torch import testing
    from autodist_tpu_torch.kernel import collective_matmul as cm
    from autodist_tpu_torch.kernel import quant_ring as qr
    from autodist_tpu_torch.kernel import quantize as qz
    from autodist_tpu_torch.parallel import tensor as tp
    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    testing.init_rank(rank, world, store)
    axis = port.ResourceSpec({"mesh": {"model": world}}).make_mesh().axis(
        "model")
    assert (axis.size, axis.index) == (world, rank)
    data = torch.load(inp)
    res = {"ring": [qr.quantized_ring_all_reduce(xs[rank], axis)
                    for xs in data["ring"]],
           "int8": [qz.quantized_psum(xs[rank], axis, "int8")
                    for xs in data["ring"]]}
    # The scope fix: the forward picks the ring under the scopes, the
    # backward runs after they closed and still takes it.
    x = data["ring"][0][rank].clone().requires_grad_()
    with tp.precision_scope({"tp_psum": "int8"}), tp.kernel_scope(
            ["quant_ring"]):
        y = tp.gather_grads(x, axis)
        z = tp.sum_partials(data["ring"][1][rank], axis)
    y.backward(data["ring"][0][(rank + 1) % world])
    res["scoped_grad"], res["scoped_fwd"] = x.grad, z
    if world == 2:
        res["matmul"] = []
        for xf, kf, axes, xd, kd in data["matmul"]:
            xl = xf.chunk(2, dim=xd)[rank].clone().requires_grad_()
            kl = kf.chunk(2, dim=kd)[rank].clone().requires_grad_()
            outs = []
            for fused in (False, True):
                fn = (cm.collective_matmul_row_fused if fused
                      else tp.collective_matmul_row)
                y = fn(xl, kl, axis, axes)
                gx, gk = torch.autograd.grad((y ** 2).sum(), (xl, kl))
                outs.append((y.detach(), gx, gk))
            res["matmul"].append(outs)
    torch.save(res, f"{out}.{rank}")
    testing.end_rank()
""")


def _run_gloo(world, inputs, tmp):
    tmp = tmp / f"world{world}"
    tmp.mkdir()
    inp, out = str(tmp / "in.pt"), str(tmp / "out")
    torch.save(inputs, inp)
    testing.launch(_WORKER, world, (inp, out), tmp=tmp, timeout=240)()
    return [torch.load(f"{out}.{r}") for r in range(world)]


def _ring_inputs(n):
    return [np.random.RandomState(size).randn(n, size).astype(np.float32)
            for size in RING_SIZES]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results at 2 and 4 ranks."""
    tmp = tmp_path_factory.mktemp("gloo")
    out = {}
    for n in (2, 4):
        r = np.random.RandomState(7)
        matmul = [(torch.as_tensor(r.randn(*xs).astype(np.float32)),
                   torch.as_tensor(r.randn(*ks).astype(np.float32)),
                   axes, xd, kd) for xs, ks, axes, xd, kd in MATMUL_CASES]
        out[n] = _run_gloo(n, {"ring": [torch.as_tensor(x)
                                        for x in _ring_inputs(n)],
                               "matmul": matmul}, tmp)
    return out


def _shard_map(fn, n, in_spec, out_spec):
    mesh = Mesh(np.array(jax.devices()[:n]), ("model",))
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_spec,
                                 out_specs=out_spec, check_vma=False))


@pytest.mark.parametrize("n", [2, 4])
def test_ring_on_gloo_ranks_matches_jax(ranks, n):
    """Every rank's ring result equals the JAX package's host mirror of
    the ring bit for bit, and its ``shard_map`` ring (Pallas hops in
    interpret mode) within 1e-6, at sizes that do and do not divide."""
    from autodist_tpu.kernel.pallas.quant_ring import (
        quantized_ring_all_reduce, reference_ring_all_reduce)

    ring = _shard_map(lambda x: quantized_ring_all_reduce(x[0], "model")[None],
                      n, P("model"), P("model"))
    for i, xs in enumerate(_ring_inputs(n)):
        want = reference_ring_all_reduce(list(xs))
        got_sm = np.asarray(ring(jnp.asarray(xs)))
        for r in range(n):
            got = ranks[n][r]["ring"][i].numpy()
            np.testing.assert_array_equal(got, np.asarray(want[r]))
            np.testing.assert_allclose(got, got_sm[r], atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_composed_int8_psum_matches_jax(ranks, n):
    """``quantized_psum(..., "int8")`` (shared scale, levels summed on
    an fp16 wire) against the JAX package's on ``n`` CPU devices."""
    from autodist_tpu.kernel import quantize as jqz

    psum = _shard_map(
        lambda x: jqz.quantized_psum(x[0], "model", "int8")[None], n,
        P("model"), P("model"))
    for i, xs in enumerate(_ring_inputs(n)):
        want = np.asarray(psum(jnp.asarray(xs)))
        for r in range(n):
            np.testing.assert_array_equal(ranks[n][r]["int8"][i].numpy(),
                                          want[r])


@pytest.mark.parametrize("n", [2, 4])
def test_backward_outside_the_scope_still_takes_the_ring(ranks, n):
    """``gather_grads`` picks its reduction when its forward runs: a
    ``backward()`` after the scopes closed sums the cotangents on the
    int8 ring (the ring's exact result, not the fp32 sum)."""
    cts = [torch.as_tensor(x) for x in _ring_inputs(n)[0]]
    cts = [cts[(r + 1) % n] for r in range(n)]
    want = qr.reference_ring_all_reduce(cts)
    exact = torch.stack(cts).sum(0)
    fwd = qr.reference_ring_all_reduce(
        [torch.as_tensor(x) for x in _ring_inputs(n)[1]])
    for r in range(n):
        got = ranks[n][r]["scoped_grad"]
        torch.testing.assert_close(got, want[r], atol=0, rtol=0)
        assert not torch.equal(got, exact)
        torch.testing.assert_close(ranks[n][r]["scoped_fwd"], fwd[r],
                                   atol=0, rtol=0)


@pytest.mark.parametrize("case", range(len(MATMUL_CASES)))
def test_collective_matmul_on_two_ranks_matches_jax(ranks, case):
    """The composed and the fused ring on 2 gloo ranks against the JAX
    package's ``shard_map`` of the same functions on 2 CPU devices, the
    output and the gradients of ``sum(y ** 2)`` within 1e-5."""
    from autodist_tpu.kernel.pallas.collective_matmul import \
        collective_matmul_row_fused
    from autodist_tpu.parallel.tensor import collective_matmul_row

    xs, ks, axes, xd, kd = MATMUL_CASES[case]
    r = np.random.RandomState(7)
    arrays = [(r.randn(*a).astype(np.float32), r.randn(*b).astype(np.float32))
              for a, b, *_ in MATMUL_CASES]
    x, kern = arrays[case]
    specs = tuple(P(*[("model" if d == md else None) for d in range(nd)])
                  for md, nd in ((xd, len(xs)), (kd, len(ks))))
    for f, fn in enumerate((collective_matmul_row,
                            collective_matmul_row_fused)):
        def g(xl, kl, fn=fn):
            return fn(xl, kl, "model", axes)

        def grads(xl, kl, g=g):
            # Each rank's own loss, as in the pipeline lowering's step.
            return jax.grad(lambda a, b: jnp.sum(g(a, b) ** 2),
                            argnums=(0, 1))(xl, kl)

        y = _shard_map(g, 2, specs, P())(x, kern)
        gx, gk = _shard_map(grads, 2, specs, specs)(x, kern)
        for rank in range(2):
            ty, tgx, tgk = ranks[2][rank]["matmul"][case][f]
            np.testing.assert_allclose(ty.numpy(), np.asarray(y),
                                       atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(
                tgx.numpy(), np.split(np.asarray(gx), 2, axis=xd)[rank],
                atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(
                tgk.numpy(), np.split(np.asarray(gk), 2, axis=kd)[rank],
                atol=1e-5, rtol=1e-5)
