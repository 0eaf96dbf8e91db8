"""Every remaining family trained on a mesh under its own plan
(chip_smoke.py ``--mesh-families``): its rank functions at the SMOKE size
on 4 gloo CPU ranks, held against the reference's ``make_train_step``
under the same plan on 4 forced XLA CPU devices; the Supervisor's restart
held to the uninterrupted run bit for bit, and again in a second run of
the mode in one checkout; a control whose frames come
from the other data rank's rows; the local-head kernel checks' masks and
pad; the mode's exit without four cards; and, marked ``gpu``, two of the
runs on four cards.

The ranks run ``chip_smoke._mesh_rank`` with a CPU spec
(``family_spec(device="cpu", smoke=True)``) on (data=2, model=2): (f)
gemma-7b, (g) zamba2-7b (its constant leaves drawn), (h) whisper-base
(``frames`` in the batch), (i) llama-3.2-vision-90b (``vision`` in the
batch, its gates 0.5), each with ``launch.dryrun.PLANS``' n_micro, fsdp
and moments, 3 steps of launch.train's optimizer (lr 3e-4, warmup and
total 3); (j) llama3-8b under ``fault.Supervisor`` with a fault at step 3.
The reference runs the same weights (the port's, carried over as numpy)
and the same batches in a subprocess. Tolerances are
``tests/test_torch_mesh_cards.py``'s: losses and gradient norms 1e-5
relative at every step; the parameters after the first step at most 2 lr
off, and 5e-5 on all but 0.1% (``_params_rule``).

Spawned ranks import nothing of JAX: the reference is imported only in
the subprocess, and chip_smoke.py imports none of it.
"""
import concurrent.futures
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.convert import lm_params_to_numpy
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import flash_cuda as fc
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, ranks
from repro_torch.models.lm import LM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 32 tokens a sequence: past ~48 the reference's SSD gradient overflows at
# zamba2's drawn leaves (its where-masked exp(cum_i - cum_j) reaches inf
# above the diagonal, and the where's gradient 0 * inf is NaN: 64 tokens
# give a NaN gradient norm on one device too); the port's stays finite
SEQ = 32
NICE = 10        # the ranks leave the other test workers their cores
TP_LR = 3e-4     # launch.train's --lr in chip_smoke's TRAIN_ARGV
KEYS = ("f", "g", "h", "i")
# int8 moments after two updates: a block's codes flip under any other
# reduction order, so the third step's gradient norm moves on the
# reference's own runs (llama-3.2-vision-90b's SMOKE, 32 tokens: its
# (1, 1) and (2, 2) meshes 1.6e-4 apart, the port's (2, 2) 5.6e-5 from
# the reference's; its losses 1.4e-6). Earlier steps, and float32
# moments, are held to 1e-5.
INT8_LATE_GNORM_RTOL = 1e-3


def _chip_smoke():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree, np.float32)]


def _params_rule(got, want, lr):
    """test_torch_mesh_cards' rule after one step: at most 2 lr off, and
    5e-5 on all but 0.1%."""
    err = np.concatenate([np.abs(a - b).ravel() for a, b in zip(
        _leaves(got), _leaves(want), strict=True)])
    assert np.mean(err > 5e-5) <= 1e-3, np.mean(err > 5e-5)
    assert err.max() <= 2 * lr, err.max()


# --- the reference on 4 forced CPU devices -----------------------------------
_REF = textwrap.dedent("""
    import json
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro import compat
    from repro.configs import registry
    from repro.models import lm
    from repro.optim import adamw
    from repro.train import loop
    d = dict(np.load(sys.argv[1]))
    runs = json.loads(sys.argv[3])
    out = {}

    def unflatten(prefix):
        tree = {}
        for k, v in d.items():
            if not k.startswith(prefix):
                continue
            *path, leaf = k[len(prefix):].split("/")
            t = tree
            for p in path:
                t = t.setdefault(p, {})
            t[leaf] = jnp.asarray(v)
        return tree

    def flat(tag, tree):
        for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[tag + "/" + "/".join(p.key for p in path)] = np.asarray(
                x, np.float32)

    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         **compat.axis_types_kwarg(2))
    for key, run in runs.items():
        cfg = registry.smoke_config(run["arch"], attn_impl="flash")
        model = lm.build(cfg)
        oc = adamw.AdamWConfig(lr=run["lr"], warmup_steps=run["steps"],
                               total_steps=run["steps"],
                               quantized_state=run["quantized"])
        with jax.set_mesh(mesh):
            step, _ = loop.make_train_step(model, oc, mesh,
                                           n_micro=run["n_micro"],
                                           donate=False, fsdp=run["fsdp"])
            p = unflatten(key + "/w/")
            s = adamw.init(oc, p)
            for i in range(run["steps"]):
                batch = {k: jnp.asarray(d[f"{key}/{i}/{k}"])
                         for k in run["inputs"]}
                p, s, m = step(p, s, batch)
                out[f"{key}/loss{i}"] = np.asarray(m["loss"])
                out[f"{key}/grad_norm{i}"] = np.asarray(m["grad_norm"])
                if i == 0:
                    flat(key + "/p1", p)
    np.savez(sys.argv[2], **out)
""")


def _port_weights(cs, key):
    """The seeded SMOKE weights family ``key`` trains from on the ranks
    (after its ``family_prepare``), as the reference's numpy tree."""
    arch = cs.FAMILIES[key]["arch"]
    model = LM(registry.smoke_config(arch, attn_impl="flash"),
               device="cpu", seed=0)
    prepare = cs.family_prepare(arch)
    if prepare is not None:
        prepare(model)
    return lm_params_to_numpy(model)


def _ref(cs, tmp_path):
    """The reference's make_train_step on (2, 2) under each family's
    plan, on the weights and batches the ranks take."""
    arrays, runs = {}, {}
    for key in KEYS:
        fam = cs.FAMILIES[key]
        plan = dryrun.PLANS[fam["arch"]]
        cfg = registry.smoke_config(fam["arch"])
        extra = cs.train_inputs(cfg, fam["batch"])
        ds = SyntheticLM(cfg.vocab, SEQ, fam["batch"])
        for i in range(cs.TRAIN_STEPS):
            batch = {"tokens": ds.batch_at(i), **(extra(i) if extra else {})}
            arrays.update({f"{key}/{i}/{k}": v for k, v in batch.items()})
        arrays.update({f"{key}/w/{k}": v for k, v in _flatten(
            _port_weights(cs, key)).items()})
        runs[key] = dict(arch=fam["arch"], lr=TP_LR, steps=cs.TRAIN_STEPS,
                         quantized=plan.quantized, n_micro=plan.n_micro,
                         fsdp=plan.fsdp, inputs=sorted(batch))
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, **arrays)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", _REF, str(src), str(dst),
                          json.dumps(runs)], capture_output=True, text=True,
                         env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = dict(np.load(dst))

    def tree_of(prefix):
        t = {}
        for k, v in out.items():
            if k.startswith(prefix):
                *path, leaf = k[len(prefix):].split("/")
                node = t
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = v
        return t
    return out, {key: tree_of(f"{key}/p1/") for key in KEYS}


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """chip_smoke's --mesh-families ranks at the SMOKE size on 4 gloo CPU
    ranks (and the other-frames control), beside the reference on 4
    forced CPU devices."""
    cs = _chip_smoke()
    d = tmp_path_factory.mktemp("families")
    spec = cs.family_spec(device="cpu", smoke=True, ckpt=str(d / "ckpt"),
                          seq=SEQ, phases=cs.FAMILY_PHASES
                          + ("h_other_frames",), params_out=True)
    # at full priority: under the suite's six workers, ranks at NICE (a
    # tenth of a worker's share of the cores) did not finish these five
    # runs in 400 s; alone they take 90-120 s
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(ranks.run_ranks, cs._mesh_rank, 4, str(d / "rdzv"),
                          (spec,), timeout=600)
        want, want_p = _ref(cs, d)
        got = fut.result()
    return cs, spec, got, want, want_p


@pytest.mark.parametrize("key", KEYS)
def test_family_ranks_match_reference_make_train_step(families, key):
    """(f)-(i) through launch.train on (2, 2) under the family's plan:
    every rank's losses and gradient norms equal the reference's
    make_train_step under the same plan, with the same frames / vision
    tokens, 1e-5 relative at every step; the parameters after the first
    step by the Adam rule. Under int8 moments the third step's gradient
    norm is held to INT8_LATE_GNORM_RTOL."""
    cs, _, got, want, want_p = families
    quantized = dryrun.PLANS[cs.FAMILIES[key]["arch"]].quantized
    for out in got:
        run = out[key]["timed"]
        assert out["backend"] == "gloo" and tuple(run["mesh"]) == (2, 2)
        assert len(run["hist"]) == 3
        for i, h in enumerate(run["hist"]):
            np.testing.assert_allclose(h["loss"], want[f"{key}/loss{i}"],
                                       rtol=1e-5)
            np.testing.assert_allclose(
                h["grad_norm"], want[f"{key}/grad_norm{i}"],
                rtol=INT8_LATE_GNORM_RTOL if quantized and i >= 2 else 1e-5)
    _params_rule(got[0][key]["timed"]["tree1"], want_p[key], TP_LR)


@pytest.mark.parametrize("key", KEYS)
def test_family_runs_under_its_plan(families, key):
    """Each run takes its family's plan (launch.dryrun.PLANS): n_micro
    and the moments on the command line, fsdp through build; under fsdp
    (llama-3.2-vision-90b) matrices are sharded over data on a dim model
    does not split, and without it none is. At the SMOKE size one card
    holds every plan, so the held run is the timed one."""
    cs, _, got, _, _ = families
    plan = dryrun.PLANS[cs.FAMILIES[key]["arch"]]
    for out in got:
        run = out[key]["timed"]
        assert "held" not in out[key]
        assert run["n_micro"] == plan.n_micro
        assert run["quantized"] == plan.quantized
        assert bool(run["fsdp_leaves"]) == plan.fsdp
    if plan.fsdp:
        assert "blocks.0.selfs.0.attn.wq" in got[0][key]["timed"][
            "fsdp_leaves"]


def test_supervisor_restart_matches_uninterrupted_run_bitwise(families):
    """(j): the reference's test_supervisor_restarts_from_checkpoint on
    (2, 2) with n_micro 2 and int8 moments: the history's steps are
    [0, 1, 2, 2, 3, 4], the final parameters and moments equal the
    uninterrupted run's bit for bit on every rank, and the chip's check
    passes them."""
    cs, _, got, _, _ = families
    for out in got:
        j = out["j"]
        assert j["steps"] == cs.SUP_HISTORY == [0, 1, 2, 2, 3, 4]
        assert j["leaves"] > 0 and j["bad"] == []
        assert j["latest"] == j["opt_step"] == 5
        assert j["n_micro"] == 2
    cs.supervisor_report("mesh", got, cuda=False)


def test_supervisor_report_rejects_a_restart_that_differs(families):
    """The chip's check rejects a history that did not restart and a
    state that differs in one leaf."""
    cs, _, got, _, _ = families
    no_restart = [dict(out, j=dict(out["j"], steps=[0, 1, 2, 3, 4]))
                  for out in got]
    with pytest.raises(cs.SmokeFailure, match="steps"):
        cs.supervisor_report("mesh", no_restart, cuda=False)
    differs = [dict(out, j=dict(out["j"], bad=["params__embed"]))
               for out in got]
    with pytest.raises(cs.SmokeFailure, match="differ"):
        cs.supervisor_report("mesh", differs, cuda=False)


def test_control_other_data_ranks_frames_moves_whisper_loss(families):
    """The control: each data rank's frames taken from the other data
    rank's rows (its tokens its own) move whisper's loss beyond the
    1e-5 the runs are held to, from the first step."""
    _, _, got, want, _ = families
    for out in got:
        h = out["h_other_frames"]["timed"]["hist"][0]
        assert abs(h["loss"] - want["h/loss0"]) > 1e-5 * abs(want["h/loss0"])


def test_family_report_holds_one_process_and_rejects_a_drift(families,
                                                            monkeypatch):
    """The chip's checks on (h): one process on the CPU (the card's
    place) running the same plan free-running and at the mesh's saved
    weights passes the ranks' steps; a rank whose held step's loss is
    1e-3 off fails the same-weights limit."""
    cs, spec, got, _, _ = families
    for name in ("reset_peak_memory_stats", "synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    whole, at = cs.family_one_process(torch.device("cpu"), spec, "h")
    assert set(at) == {cs.MESH_MOE_HELD}
    cs.family_report("mesh", got, "h", whole, at, cuda=False)
    off = [dict(out, h=dict(out["h"], timed=dict(
        out["h"]["timed"], hist=[dict(h, loss=h["loss"] * (1 + 1e-3))
                                 if h["step"] == cs.MESH_MOE_HELD else h
                                 for h in out["h"]["timed"]["hist"]])))
           for out in got]
    with pytest.raises(cs.SmokeFailure, match="same weights"):
        cs.family_report("mesh", off, "h", whole, at, cuda=False)


# --- the optimizer state on the mesh, made in its layout ---------------------
def _rank_zero_state(rank, world, init_file):
    """launch.train.build on (2, 2) for gemma-7b's SMOKE config, with
    float32 and int8 moments: how often the whole state was made
    (``adamw.init``), and the leaves that differ from the whole state's
    zeros placed by ``train.loop.place`` (values, dtype or layout)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import train as lt
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint
    from repro_torch.train import loop as tl
    ranks.init(rank, world, init_file)
    out = {}
    for quantized in (False, True):
        made, init = [], adamw.init
        adamw.init = lambda *a, **k: made.append(1) or init(*a, **k)
        try:
            r = lt.build(lt.parse(
                ["--arch", "gemma-7b", "--smoke", "--device", "cpu",
                 "--model-axis", "2", "--seq-len", "32", "--global-batch",
                 "4"] + ["--quantized-state"] * quantized))
        finally:
            adamw.init = init
        params = {n: p.full_tensor() for n, p in r.state["params"].items()}
        want = checkpoint._flatten(tl.place(adamw.init(r.ocfg, params),
                                            r.shardings["opt_state"]))
        got = checkpoint._flatten(r.state["opt_state"])
        bad = [k for k, w in want.items()
               if not isinstance(w, DTensor) and got[k] != w
               or isinstance(w, DTensor) and not (
                   tuple(got[k].placements) == tuple(w.placements)
                   and got[k].shape == w.shape
                   and torch.equal(got[k].to_local(), w.to_local()))]
        out[quantized] = (len(made), len(want), bad)
    return out


def test_mesh_build_makes_the_optimizer_state_in_its_layout(tmp_path):
    """launch.train.build on a mesh makes no whole optimizer state (on
    four cards gemma-7b's float32 moments, 68 GB, ran a card out of
    memory before they were sliced): every moment leaf, float32 or int8
    ``q`` and ``scale``, equals the whole state's zeros placed by the
    state shardings, on every rank."""
    got = ranks.run_ranks(_rank_zero_state, 4, str(tmp_path / "rdzv"),
                          timeout=300, nice=NICE)
    for out in got:
        for quantized, (made, leaves, bad) in out.items():
            assert made == 0 and leaves > 0 and bad == [], (quantized, bad)


# --- the local-head kernel checks: masks and pad ----------------------------
SMALL = {"tp2_d256": (1, 2, 2, 70, 256), "tp2_d112": (1, 2, 2, 70, 112),
         "tp2_d64": (2, 2, 2, 70, 64), "tp2_vlm": (1, 4, 1, 70, 128)}


def test_local_head_checks_take_the_cases_mask_and_pad(monkeypatch):
    """local_head_checks at the families' cases (shrunk): the
    bidirectional case reaches the plain versions with causal=False and
    the others causal; D = 112 runs the kernels on inputs padded to 128
    and goes through ops.flash_attention's pad (forward and backward);
    every case passes, K7 equal over two launches."""
    cs = _chip_smoke()
    cases = [(t, *SMALL[t], "float32", None, 1) for t in cs.FAMILY_TAGS]
    monkeypatch.setattr(cs, "MESH_K5_CASES", cases)
    seen = []

    def record(name, fn):
        def call(q, *a, **kw):
            seen.append((name, q.shape[-1], q.shape[1], kw.get("causal")))
            return fn(q, *a, **kw)
        return call
    for name in ("flash_fwd", "flash_fwd_plain", "flash_bwd_dq",
                 "flash_bwd_dkv", "flash_bwd_plain"):
        monkeypatch.setattr(fc, name, record(name, getattr(fc, name)))
    monkeypatch.setattr(ops, "flash_attention",
                        record("wrapper", ops.flash_attention))
    out = cs.local_head_checks(torch.device("cpu"), cs.FAMILY_TAGS)
    assert set(out) == set(cs.FAMILY_TAGS)
    for tag, (ok5, _, okb, _, same) in out.items():
        assert ok5 and okb and same, tag
    plain = {(d, h): c for n, d, h, c in seen if n.endswith("_plain")}
    assert plain[(64, 2)] is False           # tp2_d64: whisper's encoder
    assert plain[(256, 2)] and plain[(112, 2)] and plain[(128, 4)]
    # D = 112: the kernels at 128, the wrapper and the plain versions at
    # 112; no kernel call at 112
    kernels = {(n, d) for n, d, h, _ in seen
               if n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    assert {(n, 128) for n in ("flash_fwd", "flash_bwd_dq",
                               "flash_bwd_dkv")} <= kernels
    assert all(d != 112 for _, d in kernels)
    assert ("wrapper", 112, 2, True) in seen
    assert ("flash_fwd_plain", 112, 2, True) in seen


def test_family_kernel_cases_are_the_runs_local_heads():
    """FAMILY_TAGS' cases are the local heads each run gives a card on
    (2, 2): its published heads and kv heads over the model axis, its
    rows a data rank a microbatch, its sequence (the model sees one
    token fewer), whisper's 1500 frames; the kernel table's rows are
    named by tag."""
    cs = _chip_smoke()
    for key in KEYS:
        fam = cs.FAMILIES[key]
        cfg = registry.config(fam["arch"])
        plan = dryrun.PLANS[fam["arch"]]
        tag, b, h, hkv, s, d = next(c[:6] for c in cs.MESH_K5_CASES
                                    if c[0] == fam["tag"])
        model = cs.FAMILY_LAYOUT[1]
        assert (h, hkv) == (cfg.n_heads // model, cfg.n_kv_heads // model)
        assert d == cfg.hd
        assert b == fam["batch"] // plan.n_micro // cs.FAMILY_LAYOUT[0]
        assert s == (cfg.n_audio_frames if cfg.enc_dec else fam["seq"] - 1)
        assert (tag in cs.BIDIRECTIONAL) == bool(cfg.enc_dec)
        assert cs.row_name(fc.NAME, d, tag=tag) == f"{fc.NAME}_{tag}"


def test_family_phases_twice_on_one_checkpoint_prefix(tmp_path, monkeypatch):
    """--mesh-families run twice in one checkout: each run removes (j)'s
    checkpoints before and after it, so the second Supervisor starts at
    step 0 again (its history SUP_HISTORY, its restart bit for bit), not
    from the first run's last checkpoint, and none is left on disk."""
    cs = _chip_smoke()
    (tmp_path / "build").mkdir()
    monkeypatch.setattr(cs, "ROOT", tmp_path)     # the ranks' rendezvous
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    spec = cs.family_spec(device="cpu", smoke=True, seq=SEQ,
                          ckpt=str(tmp_path / "ckpt"), phases=("j",),
                          profile=False)
    for _ in range(2):
        assert not cs.family_phases(torch.device("cpu"), spec)
        assert not os.path.exists(spec["ckpt"] + "_j")


def test_mesh_families_exits_nonzero_without_four_cards():
    """--mesh-families prints no result and exits non-zero here (no
    card), as it does on a machine with fewer than four."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                          "--mesh-families"], capture_output=True, text=True,
                         env=env, timeout=120, cwd=ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_mesh_families_refuses_fewer_than_four_cards(monkeypatch, capsys):
    """On a machine with a card but fewer than four, the mode exits
    non-zero before it builds anything."""
    cs = _chip_smoke()
    built = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cs, "device_phase", lambda: ("H100, 700 W",
                                                     "NVIDIA H100", 2))
    monkeypatch.setattr(cs, "build_phase", lambda: built.append(1))
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", cs.FAMILY_FLAG])
    assert cs.main() == 1
    assert not built
    assert "needs 4 cards, 2 visible" in capsys.readouterr().err


# --- on four cards -----------------------------------------------------------
@pytest.mark.gpu
def test_cuda_families_on_four_cards(tmp_path):
    """(h) whisper-base at full width and depth and (j) the Supervisor on
    (2, 2), one NCCL rank a card, each card's FAMILY_TAGS kernel checks
    first; held as --mesh-families holds them (one process on card 0,
    the restart bit for bit). Needs four cards on one host."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices (run with -m gpu on four cards)")
    cs = _chip_smoke()
    spec = cs.family_spec(ckpt=str(tmp_path / "ckpt"), phases=("h", "j"),
                          profile=False)
    launches = cs.family_phases(torch.device("cuda", 0), spec)
    assert all(launches[f"{n}_tp2_d64"] > 0 for n in (fc.NAME, fc.DQ,
                                                      fc.DKV))
