"""The port's MoE FFN (``repro_torch.models.moe``) against the reference
(``repro.models.moe``) on the same weights and inputs, at the SMOKE sizes
of mixtral-8x7b (4 experts, top-2) and deepseek-v3-671b (8 experts,
top-2, a shared expert).

Weights are the reference's own init, carried across as numpy; inputs are
made with numpy from a seed. Routing decisions (chosen experts, slots and
drops) are held bit for bit in float32, planted exact ties included, the
gates (combine weights) and the aux loss within 1e-6 relative; the FFN's
output at the layer tolerances of test_torch_lm.py (f32 2e-5, bf16 2e-2),
its float32 gradients within 2e-5 of each leaf's largest |g|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rregistry
from repro.models import moe as rmoe
from repro_torch.configs import registry
from repro_torch.convert import tensor_from_numpy
from repro_torch.models import moe

ARCHS = ["mixtral-8x7b", "deepseek-v3-671b"]
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
# the gates, so the combine weights and the aux loss, are an ulp or two
# from the reference's: torch's float32 softmax and mean differ from XLA's
# by an ulp on the same inputs (and the router's logits are summed in
# another order); the choices, slots and drops they lead to are equal
GATE_RTOL = 1e-6


def _cfgs(arch, **over):
    return (rregistry.smoke_config(arch, **over),
            registry.smoke_config(arch, **over))


def _params(rcfg, seed=0):
    """The reference's MoE leaves, and the same as port tensors."""
    p = jax.tree.map(np.asarray, rmoe.moe_init(jax.random.PRNGKey(seed),
                                               rcfg))
    return (jax.tree.map(jnp.asarray, p),
            jax.tree.map(tensor_from_numpy, p))


def _x(shape, dtype, seed=0):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(
        getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _dense(r: moe.Routing, E):
    """The reference's (combine, dispatch) tensors from the port's slots."""
    G, S, K = r.idx.shape
    C = r.capacity
    comb = np.zeros((G, S, E, C), np.float32)
    g, s, k = np.nonzero(r.keep.numpy())
    comb[g, s, r.idx.numpy()[g, s, k], r.pos.numpy()[g, s, k]] = \
        r.gate.numpy()[g, s, k]
    disp = np.zeros((G, S, E, C), bool)
    disp[g, s, r.idx.numpy()[g, s, k], r.pos.numpy()[g, s, k]] = True
    return comb, disp


def _reference_choices(p, x_flat, K):
    """The reference route's top-k indices (moe.py:64-69)."""
    logits = jnp.einsum("gsd,de->gse", x_flat.astype(jnp.float32),
                        p["router"])
    sel = jax.nn.softmax(logits, axis=-1) + p["router_bias"]
    return np.asarray(jax.lax.top_k(sel, K)[1])


# --- capacity and routing ----------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tokens", [1, 2, 7, 64, 130, 4096, 16384])
@pytest.mark.parametrize("factor", [0.25, 1.25, 16.0])
def test_capacity_matches_reference(arch, tokens, factor):
    rcfg, pcfg = _cfgs(arch, capacity_factor=factor)
    assert moe.capacity(pcfg, tokens) == rmoe.capacity(rcfg, tokens)
    full_r = rregistry.config(arch, capacity_factor=factor)
    full_p = registry.config(arch, capacity_factor=factor)
    assert moe.capacity(full_p, tokens) == rmoe.capacity(full_r, tokens)


def _route_both(rcfg, pcfg, x_np, rp, pp):
    jx, tx = jnp.asarray(x_np), torch.from_numpy(x_np)
    comb, disp, aux = rmoe.route(rp, rcfg, jx)
    r = moe.route(pp, pcfg, tx)
    return (np.asarray(comb), np.asarray(disp), float(aux)), r


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factor", [1.25, 0.25])
def test_route_matches_reference_bitwise(arch, factor):
    """Chosen experts, slots and drops equal the reference's bit for bit
    in float32 (gates and aux within GATE_RTOL); at capacity factor 0.25
    tokens are dropped."""
    rcfg, pcfg = _cfgs(arch, capacity_factor=factor)
    rp, pp = _params(rcfg, seed=1)
    x = np.random.default_rng(2).normal(
        size=(2, 40, rcfg.d_model)).astype(np.float32)
    (comb, disp, aux), r = _route_both(rcfg, pcfg, x, rp, pp)
    C = rmoe.capacity(rcfg, 40)
    assert r.capacity == C and comb.shape[-1] == C
    np.testing.assert_array_equal(
        r.idx.numpy(), _reference_choices(rp, jnp.asarray(x), rcfg.top_k))
    got_comb, got_disp = _dense(r, rcfg.n_experts)
    np.testing.assert_array_equal(got_disp, disp)
    np.testing.assert_allclose(got_comb, comb, rtol=GATE_RTOL, atol=0)
    np.testing.assert_allclose(float(r.aux), aux, rtol=GATE_RTOL)
    dropped = int((~r.keep).sum())
    assert (dropped > 0) == (factor < 1)
    assert dropped == r.keep.numel() - int(disp.sum())


@pytest.mark.parametrize("arch", ARCHS)
def test_route_breaks_exact_ties_by_index_as_the_reference(arch):
    """Planted exact ties: tokens of zeros (every gate 1/E) and router
    columns duplicated in pairs (equal gates): the lower index is chosen
    first, as ``jax.lax.top_k`` does."""
    rcfg, pcfg = _cfgs(arch)
    rp, pp = _params(rcfg, seed=3)
    router = np.asarray(rp["router"]).copy()
    E, K = rcfg.n_experts, rcfg.top_k
    for e in range(0, E - 1, 2):
        router[:, e + 1] = router[:, e]
    rp = dict(rp, router=jnp.asarray(router))
    pp = dict(pp, router=torch.from_numpy(router))
    x = np.random.default_rng(4).normal(
        size=(1, 24, rcfg.d_model)).astype(np.float32)
    x[0, ::3] = 0.0
    (comb, disp, aux), r = _route_both(rcfg, pcfg, x, rp, pp)
    np.testing.assert_array_equal(
        r.idx.numpy(), _reference_choices(rp, jnp.asarray(x), K))
    np.testing.assert_array_equal(r.idx[0, ::3].numpy(),
                                  np.tile(np.arange(K), (8, 1)))
    # every pair is a tie: each token's top-2 is one pair, lower first
    if K == 2:
        first, second = r.idx[0, :, 0], r.idx[0, :, 1]
        assert bool((second == first + 1).all())
    got_comb, got_disp = _dense(r, E)
    np.testing.assert_array_equal(got_disp, disp)
    np.testing.assert_allclose(got_comb, comb, rtol=GATE_RTOL, atol=0)
    np.testing.assert_allclose(float(r.aux), aux, rtol=GATE_RTOL)


def test_route_tie_rule_is_not_topk():
    """The port selects by a stable sort: on a row of equal scores the
    choices are 0..K-1 in order, whatever ``torch.topk`` returns."""
    _, pcfg = _cfgs("deepseek-v3-671b")
    p = {"router": torch.zeros(pcfg.d_model, pcfg.n_experts),
         "router_bias": torch.zeros(pcfg.n_experts)}
    r = moe.route(p, pcfg, torch.randn(1, 5, pcfg.d_model))
    assert r.idx.tolist() == [[list(range(pcfg.top_k))] * 5]
    assert r.pos[0, :, 0].tolist() == list(range(5))


# --- the FFN ----------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [None, 8])
def test_moe_ffn_matches_reference(monkeypatch, arch, dtype, chunk):
    """Output and aux against the reference's; ``chunk`` sets
    ``_MOE_CHUNK_TOKENS`` on both sides, so 2 x 32 tokens run as 4 chunks
    of 2 x 8, whose capacity boundaries differ from the whole's."""
    rcfg, pcfg = _cfgs(arch, dtype=dtype)
    if chunk is not None:
        monkeypatch.setattr(rmoe, "_MOE_CHUNK_TOKENS", chunk)
        monkeypatch.setattr(moe, "_MOE_CHUNK_TOKENS", chunk)
    rp, pp = _params(rcfg, seed=5)
    jx, tx = _x((2, 32, rcfg.d_model), dtype, seed=6)
    # in a loop body of two trips: XLA's CPU runtime here refuses the
    # reference's bf16 x bf16 = f32 expert dots as top-level thunks (its
    # own chunked path runs them in such a loop)
    want, waux = jax.lax.map(lambda x: rmoe.moe_ffn(rp, rcfg, x, 1),
                             jnp.stack([jx, jx]))
    want, waux = want[0], waux[0]
    got, aux = moe.moe_ffn(pp, pcfg, tx, 1)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_gradients_match_reference(arch):
    """float32 gradients of sum(out * r) + aux through the gather dispatch
    and combine, against JAX's through the one-hot einsums: x, the
    router, the experts and the shared expert."""
    rcfg, pcfg = _cfgs(arch)
    rp, pp = _params(rcfg, seed=7)
    x = np.random.default_rng(8).normal(
        size=(2, 16, rcfg.d_model)).astype(np.float32)
    w = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    def f(p, x):
        out, aux = rmoe.moe_ffn(p, rcfg, x, 1)
        return jnp.sum(out * w) + aux

    gp, gx = jax.grad(f, argnums=(0, 1))(rp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in pp.items()
              if not isinstance(v, dict) and k != "router_bias"}
    shared = {k: v.clone().requires_grad_(True)
              for k, v in pp.get("shared", {}).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    p = dict(leaves, router_bias=pp["router_bias"])
    if shared:
        p["shared"] = shared
    out, aux = moe.moe_ffn(p, pcfg, tx, 1)
    (torch.sum(out * torch.from_numpy(w)) + aux).backward()

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=2e-5 * max(np.abs(want).max(), 1e-30))
    close(tx.grad, gx)
    for k, t in leaves.items():
        close(t.grad, gp[k])
    for k, t in shared.items():
        close(t.grad, gp["shared"][k])


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_shapes_and_init_match_reference(arch):
    """The port's leaves have the reference's shapes and dtypes: the
    router and its bias float32, the experts in cfg.dtype, the shared
    expert an FFN of moe_d_ff * n_shared_experts."""
    for dtype in ("float32", "bfloat16"):
        rcfg, pcfg = _cfgs(arch, dtype=dtype)
        want = rmoe.moe_init(jax.random.PRNGKey(0), rcfg)
        got = moe.moe_init(torch.Generator().manual_seed(0), pcfg, "cpu")
        shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), want)
        mine = jax.tree.map(lambda t: (tuple(t.shape),
                                       str(t.dtype).split(".")[1]), got)
        assert mine == shapes
        assert float(got["router_bias"].abs().sum()) == 0.0
        np.testing.assert_allclose(float(got["router"].std()), 0.02,
                                   rtol=0.2)


@pytest.mark.parametrize("step", [1e-3, 0.5])
def test_update_router_bias_matches_reference(step):
    rng = np.random.default_rng(10)
    bias = rng.normal(size=8).astype(np.float32)
    load = rng.integers(0, 20, 8).astype(np.float32)
    load[3] = load.mean()                      # sign(0) == 0 on both
    want = rmoe.update_router_bias(jnp.asarray(bias), jnp.asarray(load),
                                   step)
    got = moe.update_router_bias(torch.from_numpy(bias),
                                 torch.from_numpy(load), step)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_groups_must_divide_tokens():
    _, pcfg = _cfgs("mixtral-8x7b")
    _, pp = _params(rregistry.smoke_config("mixtral-8x7b"))
    with pytest.raises(ValueError, match="groups"):
        moe.moe_ffn(pp, pcfg, torch.zeros(1, 5, pcfg.d_model), 2)


def test_route_takes_given_choices():
    """``choices`` replaces the router's own selection (a replay following
    another run): slots and drops follow from them, gates from this run's
    own scores; its own choices give its own routing."""
    rcfg, pcfg = _cfgs("mixtral-8x7b", capacity_factor=0.5)
    _, pp = _params(rcfg, seed=11)
    x = torch.randn(1, 12, pcfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    own = moe.route(pp, pcfg, x)
    same = moe.route(pp, pcfg, x, choices=own.idx)
    for a, b in zip(own[:5], same[:5]):
        assert torch.equal(a, b)
    forced = torch.zeros_like(own.idx)
    forced[..., 1] = 1                          # every token: experts 0, 1
    r = moe.route(pp, pcfg, x, choices=forced)
    C = r.capacity
    assert r.pos[0, :, 0].tolist() == list(range(12))
    assert r.keep[0, :, 0].tolist() == [i < C for i in range(12)]
    gates, _ = moe.selection_scores(pp, x)
    kept = r.keep.float()
    want = torch.gather(gates, -1, forced) * kept
    want = want / torch.clamp_min(want.sum(-1, keepdim=True), 1e-9)
    torch.testing.assert_close(r.gate, want, rtol=0, atol=0)
