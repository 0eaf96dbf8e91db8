"""Serving on a mesh (chip_smoke.py ``--mesh-serve``): ``LM.prefill`` /
``decode`` and ``serve.engine.Engine`` with the parameters laid out by
``sharding.rules`` on 4 gloo CPU ranks, against the reference.

(a) The cache write. ``layers.write_seq`` into a cache split over its
sequence dim (``[Shard(0), Shard(1)]`` on (2, 2), ``[Replicate(),
Shard(1)]`` on (1, 4)) must equal the dense write exactly, where the
written rows cross a shard's edge, where one row falls on a shard's last
row, for a whole-cache prefill write and on uneven shards. The checker
must reject the slice assignment that DTensor drops (the fault the
repair removes).

(b) Every registry family at its SMOKE size (float32), on (2, 2) and on
(1, 4) where the model axis divides the heads (rwkv6-1.6b's 2 heads do
not): two waves of 4 requests through ``Engine``, a prefill and 4 decode
steps each (``Engine`` decodes once after a request's last token, as the
reference's does), held to the reference's one-device ``Engine`` on the same
weights (carried to the ranks as numpy trees by ``convert``): the tokens
equal, every logit row within 1e-5 of its largest |logit|. An MoE
model's dispatch groups are the batch's shards on the mesh
(``rules.batch_groups``: 2 at (2, 2), 1 at (1, 4)), so the reference runs
with ``moe_groups`` set to the same number, as the reference's dry run
sets it. zamba2-7b and rwkv6-1.6b take drawn constant leaves
(``test_torch_mamba2.perturb_ssm``), llama-3.2-vision-90b drawn gates
(``test_torch_vlm._gated``); whisper-base and the VLM take frames and
vision tokens through ``Engine``'s extra inputs. SMOKE llama3-8b (8 heads,
2 kv heads) at model 4 is the k/v cache split over T; deepseek-v3-671b
is MLA, whose latent cache is split over T at any model axis above 1.
With the write dropped (the slice assignment), both must fail.

(c) The cache that prefill makes on a mesh has ``rules.cache_shardings``'
placements, and each rank holds only its shard.

rwkv6-1.6b's WKV recurrence runs on each rank's heads in a ``local_map``
region (torch 2.11 refuses the sharding rule of its batched product): a
training step's gradients on (2, 2) are held to one process's.

Every case runs in one group of ranks. Spawned ranks import nothing of
JAX: this module imports the reference only inside the functions the
parent runs.
"""
import concurrent.futures
import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import ranks
from repro_torch.launch.mesh import make_host_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("llama3-8b", "mixtral-8x7b", "deepseek-v3-671b",
         "deepseek-coder-33b", "gemma-7b", "minitron-8b", "zamba2-7b",
         "rwkv6-1.6b", "llama-3.2-vision-90b", "whisper-base")
LAYOUTS = ((2, 2), (1, 4))
SLOTS, NEW, MAX_LEN = 4, 4, 24
LENGTHS = (3, 9, 5, 12, 2, 7, 10, 6)        # two waves of SLOTS
LOGIT_REL = 1e-5
# the dropped-write controls: the two T-split caches of (b)
CONTROLS = (("llama3-8b", (1, 4)), ("deepseek-v3-671b", (2, 2)))
# (a): (name, T, idx, S) on a (B, T, 2, 3) cache; T 16 is 4 rows a shard
# at model 4 and 8 at model 2, T 18 uneven at model 4 (5, 5, 5, 3)
WRITES = (("cross_edges", 16, 3, 6), ("last_row_of_shard", 16, 7, 1),
          ("whole_cache", 16, 0, 16), ("uneven_shards", 18, 9, 7))


def cases():
    """(arch, layout) of (b): every family on (2, 2), and on (1, 4) where
    the model axis divides its heads."""
    out = []
    for arch in ARCHS:
        for lay in LAYOUTS:
            if registry.smoke_config(arch).n_heads % lay[1] == 0:
                out.append((arch, lay))
    return out


def _case_id(case):
    arch, lay = case
    return f"{arch}-{lay[0]}x{lay[1]}"


def _groups(arch, lay):
    """The MoE dispatch groups of a SLOTS-row batch on ``lay``."""
    return lay[0] if registry.smoke_config(arch).is_moe else 1


def _prompts(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in LENGTHS]


def _extra(cfg):
    """``Engine``'s extra inputs for a cross-attending family: normal *
    0.1 float32 (SLOTS, T, d_model) frames or vision tokens."""
    from repro_torch.models.lm import cross_inputs
    rng = np.random.default_rng(5)
    return {k: (rng.normal(size=(SLOTS, *shape)) * 0.1).astype(np.float32)
            for k, shape in cross_inputs(cfg).items()}


# --- the ranks -----------------------------------------------------------------
class _Recording:
    """The LM as ``Engine`` sees it, keeping every call's logits whole."""

    def __init__(self, model):
        self.model, self.logits = model, []

    def _keep(self, out):
        logits, cache = out
        self.logits.append(logits.full_tensor().numpy())
        return logits, cache

    def prefill(self, batch, max_len):
        return self._keep(self.model.prefill(batch, max_len))

    def decode(self, cache, tokens):
        return self._keep(self.model.decode(cache, tokens))


def _dense_write(cache, idx, new):
    """The slice assignment: a DTensor cache split over the sequence dim
    loses it unless it writes the whole dim (the fault the repair
    removes)."""
    cache[:, idx:idx + new.shape[1]] = new


def _no_write(cache, idx, new):
    """A write that writes nothing (the planted dropped write)."""


WRITERS = ("write_seq", "slice_assignment", "dropped")


def _write_case(mesh, t, idx, s, write):
    """``write`` of (4, s, 2, 3) rows at ``idx`` into a (4, t, 2, 3) cache
    of ones split over t (and the batch over data): (equal to the dense
    write, the cache's placements kept)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    gen = torch.Generator().manual_seed(t * 100 + idx)
    base = torch.randn((4, t, 2, 3), generator=gen)
    new = torch.randn((4, s, 2, 3), generator=gen)
    data = [Shard(0) if mesh.size(0) > 1 else Replicate()]
    cache = distribute_tensor(base.clone(), mesh, data + [Shard(1)])
    write(cache, idx, distribute_tensor(new, mesh, data + [Replicate()]))
    want = base.clone()
    want[:, idx:idx + s] = new
    return (bool(torch.equal(cache.full_tensor(), want)),
            tuple(cache.placements) == tuple(data + [Shard(1)]))


def _cache_layout(model, mesh, cache):
    """Every tensor leaf of ``cache``: its placements against
    ``rules.cache_shardings``', and whether this rank holds only its own
    shard. Returns the leaves that differ (path, why)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro_torch.sharding import rules
    want = rules.cache_shardings(cache, mesh)
    bad, n = [], 0

    def walk(c, w, path):
        nonlocal n
        for k, v in c.items():
            if isinstance(v, dict):
                walk(v, w[k], path + (k,))
                continue
            if not isinstance(v, torch.Tensor):
                continue
            n += 1
            name = "/".join(path + (k,))
            if not isinstance(v, DTensor):
                bad.append((name, "not a DTensor"))
                continue
            if tuple(v.placements) != tuple(w[k].placements):
                bad.append((name, f"{v.placements} != {w[k].placements}"))
            shape, _ = compute_local_shape_and_global_offset(
                v.shape, mesh, v.placements)
            local = v.to_local()
            held = local.untyped_storage().nbytes()
            if (tuple(local.shape) != tuple(shape)
                    or held != local.numel() * local.element_size()):
                bad.append((name, f"local {tuple(local.shape)} of {held} "
                                  f"bytes, shard {tuple(shape)}"))
    walk(cache, want, ())
    return n, bad


def _serve(arch, lay, tree, control=False):
    """(b) and (c) of one case on this rank: the family's SMOKE model on
    a ``lay`` mesh, served through ``Engine``; with ``control`` the cache
    writes are the slice assignment."""
    from repro_torch.models import layers
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.sharding import rules
    from repro_torch.train import loop as tl
    cfg = registry.smoke_config(arch, attn_impl="flash")
    mesh = make_host_mesh(lay[1], device="cpu")
    model = lm_params_from_numpy(cfg, tree, device="cpu")
    tl.distribute_model(model, rules.params_shardings(
        tl.params_of(model), mesh, stacks=model.stack_dims()))
    rec = _Recording(model)
    eng = Engine(rec, batch_slots=SLOTS, max_len=MAX_LEN,
                 extra_inputs=_extra(cfg))
    reqs = [Request(i, p, max_new_tokens=NEW, eos_id=-1)
            for i, p in enumerate(_prompts(cfg.vocab))]
    patch = (contextlib.nullcontext() if not control else
             _patched(layers, "write_seq", _dense_write))
    with patch:
        res = eng.serve(reqs)
        _, cache = model.prefill({"tokens": np.stack(
            [p[:2] for p in _prompts(cfg.vocab)[:SLOTS]]), **_extra(cfg)},
            MAX_LEN)
    out = {"tokens": [(r.uid, r.tokens.tolist()) for r in res],
           "logits": rec.logits}
    if not control:
        out["layout"] = _cache_layout(model, mesh, cache)
    return out


@contextlib.contextmanager
def _patched(mod, name, fn):
    orig = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, orig)


def _wkv_grads(tree):
    """rwkv6-1.6b's gradients of one batch on (2, 2) against one
    process's on the same weights: each leaf's largest difference over
    its largest |g|."""
    from repro_torch.data import pipeline
    from repro_torch.optim import adamw
    from repro_torch.train import loop as tl
    cfg = registry.smoke_config("rwkv6-1.6b")
    toks = np.random.default_rng(3).integers(1, cfg.vocab, (4, 17))
    one = lm_params_from_numpy(cfg, tree, device="cpu")
    one.requires_grad_(True)
    one.loss({"tokens": toks})[0].backward()
    mesh = make_host_mesh(2, device="cpu")
    model = lm_params_from_numpy(cfg, tree, device="cpu")
    model.requires_grad_(True)
    _, shardings = tl.make_train_step(model, adamw.AdamWConfig(), mesh)
    state = shardings(tl.params_of(model)).distribute({})
    _, _, grads = tl.microbatch_grads(model, state["params"],
                                      pipeline.make_global_batch(
                                          mesh, {"tokens": toks}), 1)
    out = {}
    for name, p in one.named_parameters():
        got = grads[name].full_tensor()
        out[name] = float((got - p.grad).abs().max()
                          / max(float(p.grad.abs().max()), 1e-30))
    return out


def _serve_rank(rank, world, init_file, trees, serve_cases, controls):
    from repro_torch.models import layers
    ranks.init(rank, world, init_file)
    out = {"writes": {}, "serve": {}, "controls": {}}
    for lay in LAYOUTS:
        mesh = make_host_mesh(lay[1], device="cpu")
        for name, t, idx, s in WRITES:
            out["writes"][(lay, name)] = dict(zip(WRITERS, (
                _write_case(mesh, t, idx, s, w)
                for w in (layers.write_seq, _dense_write, _no_write))))
    for arch, lay in serve_cases:
        out["serve"][(arch, lay)] = _serve(arch, lay, trees[arch])
    for arch, lay in controls:
        out["controls"][(arch, lay)] = _serve(arch, lay, trees[arch],
                                              control=True)
    out["wkv_grads"] = _wkv_grads(trees["rwkv6-1.6b"])
    return out


# --- the reference, one device -------------------------------------------------
def _ref_tree(arch):
    """The reference's SMOKE parameters of ``arch`` (``init(PRNGKey(1))``;
    zamba2-7b's and rwkv6-1.6b's constant leaves drawn, the VLM's gates
    drawn), as a numpy tree."""
    import jax

    from repro.configs import registry as rregistry
    from repro.models import lm as rlm
    params = rlm.build(rregistry.smoke_config(arch)).init(
        jax.random.PRNGKey(1))
    cfg = registry.smoke_config(arch)
    if cfg.ssm_state or cfg.rwkv:
        from test_torch_mamba2 import perturb_ssm
        params = perturb_ssm(params, 1)
    if cfg.cross_attn_every:
        from test_torch_vlm import _gated
        params = _gated(params, 1)
    return jax.tree.map(np.asarray, params)


def _ref_serve(arch, tree, groups):
    """The reference's one-device ``Engine`` on ``tree`` (flash prefill
    under a (1, 1) mesh, as tests/test_torch_serve.py runs it), the MoE
    dispatch in ``groups`` groups: the tokens, and every prefill's and
    decode step's logits."""
    import jax

    from repro import compat
    from repro.configs import registry as rregistry
    from repro.models import lm as rlm
    from repro.serve.engine import Engine as RefEngine
    from repro.serve.engine import Request as RefRequest
    over = {"moe_groups": groups} if groups > 1 else {}
    rcfg = rregistry.smoke_config(arch, attn_impl="flash", **over)
    model = rlm.build(rcfg)
    cfg = registry.smoke_config(arch)
    eng = RefEngine(model, jax.tree.map(jax.numpy.asarray, tree),
                    batch_slots=SLOTS, max_len=MAX_LEN,
                    extra_inputs=_extra(cfg))
    logits = []

    def keep(fn):
        def call(*args):
            out = fn(*args)
            logits.append(np.asarray(out[0]))
            return out
        return call
    eng._prefill, eng._decode = keep(eng._prefill), keep(eng._decode)
    reqs = [RefRequest(i, p, max_new_tokens=NEW, eos_id=-1)
            for i, p in enumerate(_prompts(cfg.vocab))]
    with jax.set_mesh(jax.make_mesh((1, 1), ("data", "model"),
                                    **compat.axis_types_kwarg(2))):
        res = eng.serve(reqs)
    return {"tokens": [(r.uid, np.asarray(r.tokens).tolist()) for r in res],
            "logits": logits}


def _worst(got, want):
    """The largest |got - want| of a logit row over that row's largest
    |want|, over every call."""
    assert len(got) == len(want)
    worst = 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        worst = max(worst, float(np.max(np.abs(g - w).max(-1)
                                        / np.abs(w).max(-1))))
    return worst


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The ranks (every (a) write, every (b) case and the controls)
    beside the reference's one-device engines."""
    serve_cases = cases()
    trees = {arch: _ref_tree(arch) for arch in ARCHS}
    want = {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(ranks.run_ranks, _serve_rank, 4,
                          str(tmp_path_factory.mktemp("rdzv") / "f"),
                          (trees, serve_cases, CONTROLS), timeout=600)
        for arch, lay in serve_cases:
            g = _groups(arch, lay)
            if (arch, g) not in want:
                want[arch, g] = _ref_serve(arch, trees[arch], g)
        got = fut.result()
    return got, want


# --- (a) the write ---------------------------------------------------------------
@pytest.mark.parametrize("lay", LAYOUTS, ids=lambda lay: f"{lay[0]}x{lay[1]}")
@pytest.mark.parametrize("name", [w[0] for w in WRITES])
def test_sequence_split_cache_write_equals_dense_write(served, lay, name):
    """``write_seq`` into a T-split cache equals the dense write exactly,
    on every rank, and keeps the cache's layout."""
    got, _ = served
    for r, out in enumerate(got):
        equal, kept = out["writes"][(lay, name)]["write_seq"]
        assert equal and kept, (r, equal, kept)


def test_checker_rejects_a_dropped_write(served):
    """The same check fails a write that writes nothing, at every case
    and layout, and the slice assignment wherever it writes part of the
    split dim (DTensor gathers the dim into a copy and writes there); a
    slice of the whole dim is the cache itself, and takes the write."""
    got, _ = served
    for out in got:
        for (lay, name), res in out["writes"].items():
            assert not res["dropped"][0], (lay, name)
            assert res["slice_assignment"][0] == (name == "whole_cache"), \
                (lay, name)


# --- (b) every family through Engine -------------------------------------------
@pytest.mark.parametrize("case", cases(), ids=_case_id)
def test_family_served_on_a_mesh_matches_reference_engine(served, case):
    """Two waves through ``Engine`` on the mesh: every rank's tokens equal
    the reference's one-device engine's, and every prefill's and decode
    step's logit rows within LOGIT_REL of each row's largest |logit|."""
    got, want = served
    arch, lay = case
    ref = want[arch, _groups(arch, lay)]
    for r, out in enumerate(got):
        run = out["serve"][case]
        assert run["tokens"] == ref["tokens"], r
        assert len(run["logits"]) == 2 * (NEW + 1)
        err = _worst(run["logits"], ref["logits"])
        assert err <= LOGIT_REL, (r, err)


@pytest.mark.parametrize("case", CONTROLS, ids=_case_id)
def test_dropped_cache_write_fails_the_check(served, case):
    """The control: with the slice assignment in place of ``write_seq``
    the T-split caches (k/v at model 4 with 2 kv heads; MLA's latents)
    stay zero and the logits leave the reference's by far more than
    LOGIT_REL."""
    got, want = served
    arch, lay = case
    ref = want[arch, _groups(arch, lay)]
    for out in got:
        assert _worst(out["controls"][case]["logits"], ref["logits"]) \
            > 1e3 * LOGIT_REL


# --- (c) the laid-out cache -------------------------------------------------------
@pytest.mark.parametrize("case", cases(), ids=_case_id)
def test_prefill_cache_is_laid_out_by_the_rules(served, case):
    """Every leaf of the cache prefill makes on the mesh is a DTensor with
    ``rules.cache_shardings``' placements, and each rank's storage holds
    its own shard alone."""
    got, _ = served
    for r, out in enumerate(got):
        n, bad = out["serve"][case]["layout"]
        assert n > 0 and not bad, (r, bad)


def test_rwkv6_wkv_region_gradients_match_one_process(served):
    """A training step's gradients of rwkv6-1.6b on (2, 2), its WKV
    recurrence in the ``local_map`` region, within 1e-4 of each leaf's
    largest |g| of one process's."""
    got, _ = served
    for out in got:
        worst = max(out["wkv_grads"], key=out["wkv_grads"].get)
        assert out["wkv_grads"][worst] <= 1e-4, (worst,
                                                 out["wkv_grads"][worst])


# --- chip_smoke --mesh-serve ---------------------------------------------------------
def _chip_smoke():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


def test_mesh_serve_exits_nonzero_without_four_cards():
    """--mesh-serve prints no result and exits non-zero here (no card),
    as it does on a machine with fewer than four."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                          "--mesh-serve"], capture_output=True, text=True,
                         env=env, timeout=120, cwd=ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_mesh_serve_refuses_fewer_than_four_cards(monkeypatch, capsys):
    """On a machine with a card but fewer than four, the mode exits
    non-zero before it builds anything."""
    cs = _chip_smoke()
    built = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cs, "device_phase", lambda: ("H100, 700 W",
                                                     "NVIDIA H100", 2))
    monkeypatch.setattr(cs, "build_phase", lambda: built.append(1))
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", cs.SERVE_MESH_FLAG])
    assert cs.main() == 1
    assert not built
    assert "needs 4 cards, 2 visible" in capsys.readouterr().err


@pytest.mark.gpu
def test_cuda_mesh_serve_on_four_cards():
    """``python3 chip_smoke.py --mesh-serve`` on four cards: (k) llama3-8b
    whole on (1, 4) and (2, 2) and (l) deepseek-v3-671b's MLA on (2, 2),
    each held to one process on card 0, the controls failing. Needs four
    cards on one host."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices (run with -m gpu on four cards)")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                          "--mesh-serve"], capture_output=True, text=True,
                         env=env, timeout=1500, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert '"ok": true' in res.stdout.strip().splitlines()[-1]
