"""K8 and the quantized all-to-all ring, against the JAX package on the CPU.

``fused_hop_plain`` (what K8 computes) is held bit for bit to the Pallas
``_dq_and_q_kernel`` in interpret mode.  The ring, its transposed
backward, the composed bf16 and int8 exchanges and the expert layer run
on 2 and 4 gloo ranks in subprocesses; every rank's inputs are made with
numpy, and the results are held to the JAX package's host mirror of the
ring (bit for bit) and to its functions under ``shard_map`` (1e-6; the
int8 exchange bit for bit).  The Pallas modules are imported inside the
tests (``tests/conftest.py`` guard).
"""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from autodist_tpu_torch import testing
from autodist_tpu_torch.kernel import a2a_ring as ar
from autodist_tpu_torch.parallel.axis import Axis

RING_CASES = {2: [(4, 16)], 4: [(8, 5), (4, 16)]}   # (rows, cols) per rank
PRECISIONS = ("fp32", "bf16", "int8")
# The expert layer: G tokens of width M per rank, E experts of hidden H.
G, E, M, H = 8, 4, 16, 32
FFN_PROGRAMS = {"fp32": (None, False), "bf16": ("bf16", False),
                "int8": ("int8", False), "a2a_ring": ("int8", True)}


def _hop_inputs(L, seed):
    r = np.random.RandomState(seed)
    return (r.randint(-127, 128, L).astype(np.int8),
            np.float32(r.uniform(0.001, 0.1)),
            (r.randn(L) * 3).astype(np.float32))


@pytest.mark.parametrize("L,case", [(2 ** 12, "hop"), (1000, "hop"),
                                    (1, "hop"), (2 ** 12 + 3, "hop"),
                                    (1000, "warm_up"), (1000, "last")])
def test_fused_hop_plain_is_the_pallas_kernel(L, case):
    """The plain hop against ``_fused_hop`` in interpret mode, bit for
    bit: arrived, levels and scale; the warm-up (``scale_in = 0``, zero
    levels) and the last hop (all-zero ``nxt``) included."""
    from autodist_tpu.kernel.pallas.a2a_ring import _fused_hop

    q, s, nxt = _hop_inputs(L, L)
    if case == "warm_up":
        q, s = np.zeros_like(q), np.float32(0.0)
    if case == "last":
        nxt = np.zeros_like(nxt)
    ja, jq, js = _fused_hop(jnp.asarray(q)[None], jnp.asarray(s),
                            jnp.asarray(nxt)[None], interpret=True)
    a, q_out, scale = ar.fused_hop(torch.as_tensor(q),
                                   torch.tensor([s]), torch.as_tensor(nxt))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja)[0])
    np.testing.assert_array_equal(q_out.numpy(), np.asarray(jq)[0])
    assert scale.numpy().tobytes() == np.asarray(js).tobytes()
    if case == "warm_up":
        assert not a.any()
    if case == "last":
        assert not q_out.any() and scale.item() == np.float32(1e-20)


def test_fused_hop_plain_on_nan_and_bad_arguments():
    """A NaN in ``nxt`` gives a NaN scale (it propagates to the
    receiver); the wrapper checks shapes."""
    nxt = torch.ones(5)
    nxt[2] = float("nan")
    a, q, s = ar.fused_hop(torch.ones(5, dtype=torch.int8),
                           torch.tensor([0.5]), nxt)
    assert torch.isnan(s) and torch.equal(a, torch.full((5,), 0.5))
    with pytest.raises(ValueError, match="differ in shape"):
        ar.fused_hop(torch.zeros(3, dtype=torch.int8), torch.zeros(1),
                     torch.zeros(4))
    with pytest.raises(ValueError, match="one value"):
        ar.fused_hop(torch.zeros(3, dtype=torch.int8), torch.zeros(2),
                     torch.zeros(3))


def test_non_dividing_split_raises():
    """A split dim the ring size does not divide fails before any
    transfer, as in the JAX package."""
    axis = Axis("expert", size=4, index=0, ranks=(0, 1, 2, 3))
    with pytest.raises(ValueError, match="must divide the 4-way"):
        ar.quantized_ring_all_to_all(torch.zeros(6, 8), axis, 0, 0)
    with pytest.raises(ValueError, match="must divide the 4-way"):
        axis.all_to_all(torch.zeros(6, 8), 0, 0)


def test_host_mirror_is_the_jax_mirror():
    """The port's ``reference_ring_all_to_all`` against the JAX
    package's, bit for bit, split and concat on different axes."""
    from autodist_tpu.kernel.pallas.a2a_ring import reference_ring_all_to_all

    r = np.random.RandomState(9)
    shards = [r.randn(8, 12).astype(np.float32) for _ in range(4)]
    for split, concat in ((0, 0), (0, 1), (1, 0)):
        want = reference_ring_all_to_all(shards, split_axis=split,
                                         concat_axis=concat)
        got = ar.reference_ring_all_to_all(shards, split, concat)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------------------- #
# gloo ranks
# --------------------------------------------------------------------------- #
_WORKER = textwrap.dedent("""
    import sys
    import torch
    import autodist_tpu_torch as port
    from autodist_tpu_torch import testing
    from autodist_tpu_torch.kernel import a2a_ring as ar
    from autodist_tpu_torch.parallel import moe
    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    testing.init_rank(rank, world, store)
    axis = port.ResourceSpec({"mesh": {"expert": world}}).make_mesh().axis(
        "expert")
    job = torch.load(inp)
    res = {"ring": [ar.quantized_ring_all_to_all(xs[rank], axis, 0, 0)
                    for xs in job["ring"]]}
    x = job["bwd_x"][rank].clone().requires_grad_()
    y = ar.ring_dispatch(x, axis, 0, 1)
    y.backward(job["bwd_ct"][rank])
    res["bwd"] = (y.detach(), x.grad)
    res["exchange"] = {}
    for prec in ("fp32", "bf16", "int8"):
        x = job["bwd_x"][rank].clone().requires_grad_()
        y = moe.quantized_all_to_all(x, axis, split_axis=0, concat_axis=1,
                                     precision=prec)
        y.backward(job["bwd_ct"][rank])
        res["exchange"][prec] = (y.detach(), x.grad)
    gate, wi, wo = job["ffn_w"]
    n_local = wi.shape[0] // world
    mine = slice(rank * n_local, (rank + 1) * n_local)
    res["ffn"] = {}
    for name, (prec, kern) in job["ffn_programs"].items():
        for key, (toks, g) in (("ffn", (job["ffn_x"][rank], gate)),
                               ("drop", (job["drop_x"][rank],
                                         job["drop_gate"]))):
            o, aux = moe.expert_parallel_ffn(
                toks, g, wi[mine], wo[mine], axis,
                capacity_factor=job["cf"][key], a2a_precision=prec,
                a2a_kernel=kern)
            res["ffn"][(key, name)] = (o, aux)
    if world == 4:
        # A joint axis that is not the whole job: expert lines of a
        # {data 1, expert 2, model 2} mesh.
        joint = port.ResourceSpec({"mesh": {"data": 1, "expert": 2,
                                            "model": 2}}).make_mesh(
        ).joint_axis(("data", "expert"))
        res["joint"] = (joint.size, joint.index, joint.ranks,
                        float(joint.psum(torch.tensor(float(rank)))))
    torch.save(res, f"{out}.{rank}")
    testing.end_rank()
""")


def _inputs(n):
    r = np.random.RandomState(n)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    ring = [[t(r.randn(rows, cols)) for _ in range(n)]
            for rows, cols in RING_CASES[n]]
    rows, cols = 8, 6
    ffn_w = (t(r.randn(M, E) * 0.5), t(r.randn(E, M, H) * 0.2),
             t(r.randn(E, H, M) * 0.2))
    # Adversarial gate: every token's top-2 is experts {0, 1} (tokens
    # carry a constant first feature), so capacity 4 < G drops tokens.
    drop_gate = np.zeros((M, E), np.float32)
    drop_gate[0, :2] = [3.0, 2.0]
    drop_x = r.randn(n, G, M).astype(np.float32) * 0.1
    drop_x[..., 0] = 1.0
    return {"ring": ring,
            "bwd_x": [t(r.randn(rows, cols)) for _ in range(n)],
            "bwd_ct": [t(r.randn(rows // n, n * cols)) for _ in range(n)],
            "ffn_w": ffn_w,
            "ffn_x": [t(r.randn(G, M)) for _ in range(n)],
            "drop_x": [t(x) for x in drop_x], "drop_gate": t(drop_gate),
            "cf": {"ffn": 8.0, "drop": 0.5},
            "ffn_programs": FFN_PROGRAMS}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results at 2 and 4 ranks, and the inputs."""
    tmp = tmp_path_factory.mktemp("a2a")
    joins = {}
    for n in (2, 4):
        inputs = _inputs(n)
        torch.save(inputs, tmp / f"in{n}.pt")
        joins[n] = (testing.launch(_WORKER, n, (tmp / f"in{n}.pt",
                                                tmp / f"out{n}"),
                                   tmp=tmp / f"job{n}", timeout=240), inputs)
    out = {}
    for n, (join, inputs) in joins.items():
        join()
        out[n] = ([torch.load(tmp / f"out{n}.{r}") for r in range(n)],
                  inputs)
    return out


def _shard_map(fn, n, in_specs, out_specs):
    mesh = Mesh(np.array(jax.devices()[:n]), ("expert",))
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _cat(ts):
    return np.concatenate([np.asarray(t) for t in ts])


@pytest.mark.parametrize("n", [2, 4])
def test_ring_on_gloo_ranks_is_the_jax_mirror(ranks, n):
    """Every rank's ring result equals the JAX package's host mirror of
    the ring bit for bit, at the JAX goldens' shapes (one row per peer
    included)."""
    from autodist_tpu.kernel.pallas.a2a_ring import reference_ring_all_to_all

    got, inputs = ranks[n]
    for c, shards in enumerate(inputs["ring"]):
        want = reference_ring_all_to_all([s.numpy() for s in shards],
                                         split_axis=0, concat_axis=0)
        for r in range(n):
            np.testing.assert_array_equal(got[r]["ring"][c].numpy(),
                                          np.asarray(want[r]))


@pytest.mark.parametrize("n", [2, 4])
def test_ring_backward_is_the_transposed_ring(ranks, n):
    """``ring_dispatch``'s backward rides the ring with split and concat
    swapped: bit for bit the JAX mirror of the transposed exchange."""
    from autodist_tpu.kernel.pallas.a2a_ring import reference_ring_all_to_all

    got, inputs = ranks[n]
    y_ref = reference_ring_all_to_all(
        [x.numpy() for x in inputs["bwd_x"]], split_axis=0, concat_axis=1)
    g_ref = reference_ring_all_to_all(
        [c.numpy() for c in inputs["bwd_ct"]], split_axis=1, concat_axis=0)
    for r in range(n):
        y, g = got[r]["bwd"]
        np.testing.assert_array_equal(y.numpy(), np.asarray(y_ref[r]))
        np.testing.assert_array_equal(g.numpy(), np.asarray(g_ref[r]))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_composed_exchange_matches_jax(ranks, n, precision):
    """``quantized_all_to_all`` forward and backward against the JAX
    function under ``shard_map``: the int8 and bf16 sandwiches bit for
    bit, fp32 exactly."""
    from autodist_tpu.parallel.moe import quantized_all_to_all

    got, inputs = ranks[n]

    def run(x, ct):
        y, vjp = jax.vjp(lambda a: quantized_all_to_all(
            a, "expert", split_axis=0, concat_axis=1,
            precision=precision), x)
        return y, vjp(ct)[0]

    y, g = _shard_map(run, n, (P("expert"), P("expert")),
                      (P("expert"), P("expert")))(
        _cat(inputs["bwd_x"]), _cat(inputs["bwd_ct"]))
    np.testing.assert_array_equal(
        _cat(got[r]["exchange"][precision][0] for r in range(n)),
        np.asarray(y))
    np.testing.assert_array_equal(
        _cat(got[r]["exchange"][precision][1] for r in range(n)),
        np.asarray(g))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("program", list(FFN_PROGRAMS))
def test_expert_layer_matches_jax(ranks, n, program):
    """``expert_parallel_ffn`` on every rank against the JAX function
    under ``shard_map`` at 1e-6, each wire program."""
    from autodist_tpu.parallel.moe import expert_parallel_ffn

    got, inputs = ranks[n]
    prec, kern = FFN_PROGRAMS[program]
    gate, wi, wo = (w.numpy() for w in inputs["ffn_w"])

    def run(tokens, gate, wi, wo):
        out, aux = expert_parallel_ffn(
            tokens, gate, wi, wo, capacity_factor=8.0, a2a_precision=prec,
            a2a_kernel=kern)
        return out, aux[None]

    out, aux = _shard_map(
        run, n, (P("expert"), P(), P("expert"), P("expert")),
        (P("expert"), P("expert")))(_cat(inputs["ffn_x"]), gate, wi, wo)
    np.testing.assert_allclose(
        _cat(got[r]["ffn"][("ffn", program)][0] for r in range(n)),
        np.asarray(out), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        [float(got[r]["ffn"][("ffn", program)][1]) for r in range(n)],
        np.asarray(aux), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_capacity_overflow_drops_stay_exact_zero(ranks, n):
    """Routing is decided in fp32 before the wire, so the ring drops
    exactly the tokens the dense reference drops, and a dropped token's
    output row stays exactly zero through the int8 hops."""
    from autodist_tpu_torch.parallel import moe

    got, inputs = ranks[n]
    gate, wi, wo = inputs["ffn_w"]
    cap = moe.expert_capacity(G, 0.5, E)
    for r in range(n):
        ring, _ = got[r]["ffn"][("drop", "a2a_ring")]
        fp32, _ = got[r]["ffn"][("drop", "fp32")]
        dense, _ = moe.dense_moe_reference(inputs["drop_x"][r],
                                           inputs["drop_gate"], wi, wo, cap)
        dropped = (dense == 0).all(-1)
        assert 0 < int(dropped.sum()) < G
        assert torch.equal(ring[dropped], torch.zeros_like(ring[dropped]))
        assert torch.equal((ring == 0).all(-1), dropped)
        torch.testing.assert_close(fp32, dense, atol=1e-6, rtol=1e-6)


def test_joint_axis_groups_the_ranks_of_a_line(ranks):
    """``Mesh.joint_axis`` over a subset of the mesh: the ranks that
    differ only on those axes, indexed row-major over them, summing in
    their own group."""
    got, _ = ranks[4]
    for r in range(4):
        e, m = divmod(r, 2)
        assert got[r]["joint"] == (2, e, (m, 2 + m), float(2 * m + 2))
