"""The port's serving engine (``repro_torch.serve.engine``) on the llama3
SMOKE config in float32 with ``attn_impl="flash"``: the four behaviours of
tests/test_serve.py replayed on the port, and the port's greedy tokens
against the reference ``Engine`` on the same weights — one request alone,
and waves with mixed prompt lengths (left-padded, with a dummy slot). The
reference runs under a 1x1 ("data", "model") mesh so that its prefill
takes its flash path, as the port's does. The MoE SMOKE models
(mixtral-8x7b, deepseek-v3-671b) and the state-space ones (zamba2-7b,
rwkv6-1.6b, their constant leaves perturbed) are held to the reference
engine's tokens the same way, and served by the launcher.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import registry as rregistry
from repro.models import lm as rlm
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import Request as RefRequest
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.serve.engine import Engine, Request


@pytest.fixture(scope="module")
def setup():
    rcfg = rregistry.smoke_config("llama3-8b", attn_impl="flash")
    cfg = registry.smoke_config("llama3-8b", attn_impl="flash")
    ref_model = rlm.build(rcfg)
    params = ref_model.init(jax.random.PRNGKey(0))
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return cfg, model, ref_model, params


def _mesh():
    return jax.set_mesh(jax.make_mesh((1, 1), ("data", "model"),
                                      **compat.axis_types_kwarg(2)))


def test_greedy_matches_manual_loop(setup):
    cfg, model, _, _ = setup
    prompt = np.asarray([5, 9, 3, 7], np.int32)
    eng = Engine(model, batch_slots=1, max_len=32)
    res = eng.serve([Request(0, prompt, max_new_tokens=5, eos_id=-1)])[0]
    logits, cache = model.prefill(prompt[None], 32)
    toks = []
    tok = torch.argmax(logits, -1)
    for _ in range(5):
        toks.append(int(tok[0]))
        logits, cache = model.decode(cache, tok)
        tok = torch.argmax(logits, -1)
    np.testing.assert_array_equal(res.tokens, np.asarray(toks))


def test_batched_equals_single(setup):
    """Wave batching must not change any request's greedy output (prompts
    of equal length: left padding changes positions)."""
    cfg, model, _, _ = setup
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, rng.integers(3, 8)).astype(np.int32)
               for _ in range(4)]
    eng1 = Engine(model, batch_slots=1, max_len=32)
    eng4 = Engine(model, batch_slots=4, max_len=32)
    same_len = [p[:3] for p in prompts]
    single = [eng1.serve([Request(i, p, max_new_tokens=4, eos_id=-1)])[0]
              for i, p in enumerate(same_len)]
    batched = eng4.serve([Request(i, p, max_new_tokens=4, eos_id=-1)
                          for i, p in enumerate(same_len)])
    for a, b in zip(single, sorted(batched, key=lambda r: r.uid)):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_eos_stops_early(setup):
    cfg, model, _, _ = setup
    prompt = np.asarray([5, 9, 3], np.int32)
    eng = Engine(model, batch_slots=1, max_len=64)
    r0 = eng.serve([Request(0, prompt, max_new_tokens=1, eos_id=-1)])[0]
    eos = int(r0.tokens[0])
    r = eng.serve([Request(0, prompt, max_new_tokens=30, eos_id=eos)])[0]
    assert len(r.tokens) == 1 and int(r.tokens[0]) == eos


def test_more_requests_than_slots(setup):
    cfg, model, _, _ = setup
    rng = np.random.default_rng(1)
    reqs = [Request(i, rng.integers(1, cfg.vocab, 4).astype(np.int32),
                    max_new_tokens=3, eos_id=-1) for i in range(5)]
    eng = Engine(model, batch_slots=2, max_len=32)
    res = eng.serve(reqs)
    assert sorted(r.uid for r in res) == [0, 1, 2, 3, 4]
    assert all(len(r.tokens) == 3 for r in res)


def _requests(cls, prompts, max_new):
    return [cls(i, p, max_new_tokens=n, eos_id=-1)
            for i, (p, n) in enumerate(zip(prompts, max_new))]


@pytest.mark.parametrize("slots,lengths,max_new", [
    (1, [6], [7]),                              # a single request
    (4, [3, 9, 5, 12, 2, 7, 10], [6, 4, 8, 6, 5, 3, 6]),   # padded waves
])
def test_tokens_equal_reference_engine(setup, slots, lengths, max_new):
    cfg, model, ref_model, params = setup
    rng = np.random.default_rng(sum(lengths))
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
               for n in lengths]
    with _mesh():
        want = RefEngine(ref_model, params, batch_slots=slots,
                         max_len=32).serve(
            _requests(RefRequest, prompts, max_new))
    got = Engine(model, batch_slots=slots, max_len=32).serve(
        _requests(Request, prompts, max_new))
    assert [r.uid for r in got] == [r.uid for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))


def test_wave_size_is_checked(setup):
    _, model, _, _ = setup
    eng = Engine(model, batch_slots=2, max_len=16)
    with pytest.raises(ValueError, match="wave"):
        eng.run_wave([])


def test_launcher_serves_on_cpu(capsys):
    res = serve_cli.main(["--smoke", "--device", "cpu", "--requests", "3",
                          "--slots", "2", "--max-new", "4"])
    assert sorted(r.uid for r in res) == [0, 1, 2]
    assert all(len(r.tokens) == 4 for r in res)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out


def test_launcher_serves_gemma_on_cpu(capsys):
    """``launch.serve --arch gemma-7b --smoke`` on the CPU: geglu, tied
    unembedding, the vocabulary's token range."""
    res = serve_cli.main(["--arch", "gemma-7b", "--smoke", "--device",
                          "cpu", "--requests", "3", "--slots", "2",
                          "--max-new", "4"])
    vocab = registry.smoke_config("gemma-7b").vocab
    assert sorted(r.uid for r in res) == [0, 1, 2]
    assert all(len(r.tokens) == 4 and bool(((r.tokens >= 0)
                                            & (r.tokens < vocab)).all())
               for r in res)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out


def test_launcher_prefill_takes_the_flash_path(monkeypatch):
    """The entry point builds its model with attn_impl="flash": every
    prefill reaches K5's binding once per layer (its plain version here)."""
    from repro_torch.kernels import flash_cuda
    calls = []
    fwd = flash_cuda.flash_fwd

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return fwd(*args, **kwargs)

    monkeypatch.setattr(flash_cuda, "flash_fwd", counted)
    serve_cli.main(["--smoke", "--device", "cpu", "--requests", "3",
                    "--slots", "2", "--max-new", "2"])
    n_layers = registry.smoke_config("llama3-8b").n_layers
    assert len(calls) == n_layers * 2          # 2 waves, one prefill each


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v3-671b"])
def test_moe_tokens_equal_reference_engine(arch):
    """The MoE SMOKE models (float32) through both engines: waves with
    mixed prompt lengths, whose left padding the router takes like any
    token, and a dummy slot; greedy tokens equal."""
    rcfg = rregistry.smoke_config(arch, attn_impl="flash")
    cfg = registry.smoke_config(arch, attn_impl="flash")
    ref_model = rlm.build(rcfg)
    params = ref_model.init(jax.random.PRNGKey(1))
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    rng = np.random.default_rng(11)
    lengths, max_new = [3, 9, 5, 12, 2, 7, 10], [6, 4, 8, 6, 5, 3, 6]
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
               for n in lengths]
    with _mesh():
        want = RefEngine(ref_model, params, batch_slots=4,
                         max_len=24).serve(
            _requests(RefRequest, prompts, max_new))
    got = Engine(model, batch_slots=4, max_len=24).serve(
        _requests(Request, prompts, max_new))
    assert [r.uid for r in got] == [r.uid for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v3-671b"])
def test_launcher_serves_moe_on_cpu(capsys, arch):
    """``launch.serve --arch <moe> --smoke`` on the CPU."""
    res = serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--requests", "3", "--slots", "2", "--max-new",
                          "4"])
    vocab = registry.smoke_config(arch).vocab
    assert sorted(r.uid for r in res) == [0, 1, 2]
    assert all(len(r.tokens) == 4 and bool(((r.tokens >= 0)
                                            & (r.tokens < vocab)).all())
               for r in res)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_ssm_tokens_equal_reference_engine(arch):
    """The state-space SMOKE models (float32, perturbed) through both
    engines: waves with mixed prompt lengths, whose left padding enters
    the SSM / WKV states like any token, and a dummy slot; greedy tokens
    equal."""
    from test_torch_mamba2 import ssm_models
    _, cfg, ref_model, params, model = ssm_models(arch, seed=1)
    rng = np.random.default_rng(11)
    lengths, max_new = [3, 9, 5, 12, 2, 7, 10], [6, 4, 8, 6, 5, 3, 6]
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
               for n in lengths]
    with _mesh():
        want = RefEngine(ref_model, params, batch_slots=4,
                         max_len=24).serve(
            _requests(RefRequest, prompts, max_new))
    got = Engine(model, batch_slots=4, max_len=24).serve(
        _requests(Request, prompts, max_new))
    assert [r.uid for r in got] == [r.uid for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_launcher_serves_ssm_on_cpu(capsys, arch):
    """``launch.serve --arch zamba2-7b|rwkv6-1.6b --smoke`` on the CPU."""
    res = serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--requests", "3", "--slots", "2", "--max-new",
                          "4"])
    vocab = registry.smoke_config(arch).vocab
    assert sorted(r.uid for r in res) == [0, 1, 2]
    assert all(len(r.tokens) == 4 and bool(((r.tokens >= 0)
                                            & (r.tokens < vocab)).all())
               for r in res)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
