"""The int8 error-feedback all-reduce (``optim.compress``) against the
reference's ``compressed_psum`` under ``shard_map``.

One rank (a world of one made by ``make_host_mesh(device="cpu")``): g_hat
and err' bitwise equal to the reference's on its one-device mesh, float32
and bf16 gradients whose sizes are not multiples of 256. Four gloo ranks
against the reference on four forced CPU devices (a subprocess), the same
inputs on each rank: the int32 sums exact, g_hat and err' bitwise (the
port sums the scales in rank order, the order of XLA's psum on the CPU;
a sum in another order differs by up to 2 float32 ulps). Error feedback keeps
the running sum, and a control with err zeroed every step must miss it.

Spawned ranks import nothing of JAX: the reference is imported inside the
tests, in the parent process, and the ranks get numpy arrays.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.convert import tensor_from_numpy, tensor_to_numpy
from repro_torch.launch import ranks
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import compress

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(1000,), (7, 37), (257,), (3, 5, 11)]


@pytest.fixture
def one_rank():
    mesh = make_host_mesh(device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def _ref_one(g, err):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import compat
    from repro.optim import compress as rcompress
    mesh = jax.make_mesh((1,), ("data",))
    f = compat.shard_map(
        lambda a, b: rcompress.compressed_psum(a, b, "data"), mesh=mesh,
        in_specs=(P(), P()), out_specs=(P(), P()))
    g_hat, new_err = f(jnp.asarray(g), jnp.asarray(err))
    return np.asarray(g_hat), np.asarray(new_err)


def _inputs(shape, dtype, seed):
    import ml_dtypes
    r = np.random.default_rng(seed)
    g = (r.standard_normal(shape) * r.uniform(0.01, 10.0)).astype(np.float32)
    if dtype == "bfloat16":
        g = g.astype(ml_dtypes.bfloat16)
    err = (r.standard_normal(shape) * 1e-3).astype(np.float32)
    return g, err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SIZES)
def test_one_rank_bitwise_equal_to_reference(one_rank, shape, dtype):
    g, err = _inputs(shape, dtype, seed=sum(shape))
    want_g, want_e = _ref_one(g, err)
    got_g, got_e = compress.compressed_psum(
        tensor_from_numpy(g), torch.from_numpy(err), (one_rank, "data"))
    assert got_g.dtype == tensor_from_numpy(g).dtype
    np.testing.assert_array_equal(tensor_to_numpy(got_g),
                                  want_g.astype(np.float32))
    np.testing.assert_array_equal(got_e.numpy(), want_e)


def test_tree_form_equals_leaf_by_leaf(one_rank):
    """One all-reduce of every leaf's codes equals one a leaf."""
    leaves = {f"l{i}": _inputs(s, "float32", seed=i)
              for i, s in enumerate(SIZES)}
    g = {k: torch.from_numpy(v[0]) for k, v in leaves.items()}
    e = {k: torch.from_numpy(v[1]) for k, v in leaves.items()}
    stats = {}
    tg, te = compress.tree_compressed_psum(g, e, (one_rank, "data"),
                                           stats=stats)
    for k in g:
        lg, le = compress.compressed_psum(g[k], e[k], (one_rank, "data"))
        assert torch.equal(tg[k], lg) and torch.equal(te[k], le)
    n = sum(int(np.prod(s)) for s in SIZES)
    blocks = sum(-(-int(np.prod(s)) // 256) for s in SIZES)
    assert stats == {"payload_bytes": blocks * 256 * 4 + blocks * 4 + 4,  # 1 rank
                     "dense_bytes": n * 4}


def test_payload_in_pieces_equals_one_call(one_rank, monkeypatch):
    """A payload longer than ``CHUNK`` goes in pieces: the same sums."""
    g = {"a": torch.from_numpy(_inputs((1000,), "float32", 3)[0])}
    e = {"a": torch.zeros(1000)}
    whole = compress.tree_compressed_psum(g, e, (one_rank, "data"))
    monkeypatch.setattr(compress, "CHUNK", 100)
    calls = []
    real = dist.all_reduce
    monkeypatch.setattr(dist, "all_reduce", lambda t, **kw: (
        calls.append(t.numel()), real(t, **kw))[1])
    pieces = compress.tree_compressed_psum(g, e, (one_rank, "data"))
    assert torch.equal(whole[0]["a"], pieces[0]["a"])
    assert torch.equal(whole[1]["a"], pieces[1]["a"])
    assert max(calls) == 100 and sum(calls) == 1024 + 4 + 1


def test_stacked_leaves_quantize_as_one(one_rank):
    """``stacks`` quantizes the per-block leaves of one reference leaf as
    that leaf: the same as compressing their concatenation, block edges
    running across them (two 64-value norm gammas share a block)."""
    r = np.random.default_rng(5)
    g = {f"blocks.{i}.ln1": torch.from_numpy(
        r.standard_normal(64).astype(np.float32) * (i + 1)) for i in range(3)}
    e = {k: torch.zeros(64) for k in g}
    stacks = {"dense.ln1": list(g)}
    got_g, got_e = compress.tree_compressed_psum(g, e, (one_rank, "data"),
                                                 stacks=stacks)
    whole_g, whole_e = compress.compressed_psum(
        torch.cat(list(g.values())), torch.zeros(192), (one_rank, "data"))
    assert torch.equal(torch.cat([got_g[k] for k in g]), whole_g)
    assert torch.equal(torch.cat([got_e[k] for k in g]), whole_e)
    alone, _ = compress.tree_compressed_psum(g, e, (one_rank, "data"))
    assert not torch.equal(torch.cat([alone[k] for k in g]), whole_g)
    with pytest.raises(KeyError, match="stacks"):
        compress.tree_compressed_psum(g, e, (one_rank, "data"),
                                      stacks={"x": ["blocks.0.ln1"]})


def _ef_run(group, zero_err: bool):
    """10 steps of one-rank compression: (sum of sent + last err, sum of
    true gradients)."""
    gen = torch.Generator().manual_seed(1)
    err = torch.zeros(256)
    sent, true = torch.zeros(256), torch.zeros(256)
    for _ in range(10):
        g = torch.randn(256, generator=gen)
        if zero_err:
            err = torch.zeros(256)
        g_hat, err = compress.compressed_psum(g, err, group)
        sent += g_hat
        true += g
    return (sent + err).numpy(), true.numpy()


def test_error_feedback_preserves_sum_over_time(one_rank):
    """Sum of transmitted gradients + residual equals the sum of the true
    gradients (the reference's test); with the residual dropped every step
    (no feedback) the sum drifts beyond the tolerance."""
    got, want = _ef_run((one_rank, "data"), zero_err=False)
    np.testing.assert_allclose(got, want, atol=1e-4)
    got, want = _ef_run((one_rank, "data"), zero_err=True)
    assert np.abs(got - want).max() > 1e-3


def test_init_error_is_float32_zeros():
    params = {"a": torch.ones(3, 4, dtype=torch.bfloat16),
              "b": torch.ones(5)}
    e = compress.init_error(params)
    assert all(e[k].dtype == torch.float32 and e[k].shape == params[k].shape
               and not e[k].any() for k in params)


def _rank_four(rank, world, init_file, gs, errs):
    """On each gloo rank: compressed_psum of its own (g, err), and the
    int32 sum of its codes."""
    ranks.init(rank, world, init_file)
    mesh = make_host_mesh(device="cpu")
    out = []
    for g, e in zip(gs, errs):
        g_t, e_t = torch.from_numpy(g[rank]), torch.from_numpy(e[rank])
        g_hat, new_err = compress.compressed_psum(g_t, e_t, (mesh, "data"))
        q, _, _ = compress._quantize(g_t.float() + e_t)
        q32 = q.to(torch.int32)
        dist.all_reduce(q32)
        out.append((g_hat.numpy(), new_err.numpy(), q32.numpy()))
    return out


_REF_FOUR = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro import compat
    from repro.optim import compress
    d = np.load(sys.argv[1])
    mesh = jax.make_mesh((4,), ("data",))
    out = {}
    for i in range(int(d["n"])):
        g, e = d[f"g{i}"], d[f"e{i}"]          # (4, ...) per rank
        def local(a, b):
            gh, ne = compress.compressed_psum(a[0], b[0], "data")
            q, _, _ = compress._quantize(a[0].astype(jnp.float32) + b[0])
            return gh[None], ne[None], q[None]
        f = compat.shard_map(local, mesh=mesh,
                             in_specs=(P("data"), P("data")),
                             out_specs=(P("data"), P("data"), P("data")))
        gh, ne, q = f(jnp.asarray(g), jnp.asarray(e))
        out[f"gh{i}"], out[f"ne{i}"], out[f"q{i}"] = map(np.asarray,
                                                          (gh, ne, q))
    np.savez(sys.argv[2], **out)
""")


def test_four_ranks_match_reference_on_four_devices(tmp_path):
    shapes = [(1000,), (7, 37), (513,)]
    gs, errs = [], []
    for i, s in enumerate(shapes):
        pairs = [_inputs(s, "float32", seed=10 * i + r) for r in range(4)]
        gs.append(np.stack([p[0] for p in pairs]))
        errs.append(np.stack([p[1] for p in pairs]))
    src = tmp_path / "in.npz"
    np.savez(src, n=len(shapes), **{f"g{i}": g for i, g in enumerate(gs)},
             **{f"e{i}": e for i, e in enumerate(errs)})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", _REF_FOUR, str(src),
                          str(tmp_path / "out.npz")], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    want = np.load(tmp_path / "out.npz")
    got = ranks.run_ranks(_rank_four, 4, str(tmp_path / "rdzv"),
                          (gs, errs), nice=10)
    for i in range(len(shapes)):
        qsum = want[f"q{i}"].astype(np.int32).sum(axis=0).reshape(-1)
        for r in range(4):
            g_hat, new_err, q32 = got[r][i]
            np.testing.assert_array_equal(q32.reshape(-1), qsum)
            np.testing.assert_array_equal(g_hat, want[f"gh{i}"][r])
            np.testing.assert_array_equal(new_err, want[f"ne{i}"][r])
        # every rank reduced to the same g_hat
        for r in range(1, 4):
            np.testing.assert_array_equal(got[r][i][0], got[0][i][0])
