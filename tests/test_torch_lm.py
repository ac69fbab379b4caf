"""The port's LM inference slice against the JAX reference on the CPU.

Configs, parameter count, each layer, the full-sequence forward (flash on
and off), prefill/decode and greedy generation, the serving launcher and
the refusals.  Both packages run the same weights: the reference's
``init_params`` pytree is carried into the port by
``repro_torch.models.convert.params_from_jax``; other inputs come from
numpy with a fixed seed.  On the CPU the port's flash branch takes the
kernel's plain version (zero launches); the reference runs its Pallas
kernel in interpret mode.

Tolerances, all in f32:
* layers 1e-5: one layer's sums in another order (XLA's CPU dot against
  torch's) stay within a few f32 ulps of O(1) values;
* forward and serving logits 1e-4 (atol and rtol): the same differences
  carried through two layers, the final norm and a 256-wide head;
* the port's own serving-vs-train check 3e-4 / 1e-3, the bound of
  ``tests/test_models_smoke.py::test_smoke_serving_consistency``
  (prefill/decode attend over another set of keys than the train pass).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as JARCHS
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.train import serve as jserve
from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch import serve as tlaunch
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.convert import params_from_jax
from repro_torch.kernels import flash_attention as tfa
from repro_torch.train import serve as tserve

LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
DENSE = ["phi3-mini-3.8b", "qwen1.5-32b", "command-r-plus-104b"]


def _np(x):
    return np.asarray(x, np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _jax_model(name, flash=True, seed=0):
    cfg = dataclasses.replace(JARCHS[name].smoke(),
                              use_flash_attention=flash)
    params = jmodel.init_params(cfg, jax.random.PRNGKey(seed),
                                dtype=jnp.float32)
    return cfg, params


def _port_model(name, params, flash=True):
    cfg = dataclasses.replace(get_arch(name).smoke(),
                              use_flash_attention=flash)
    return params_from_jax(jax.tree.map(np.asarray, params), cfg,
                           device="cpu")


# --------------------------------------------------------------------------
# configs and parameter count
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(JARCHS))
def test_configs_equal_reference(name):
    assert set(ARCHS) == set(JARCHS)
    assert dataclasses.asdict(ARCHS[name]) == dataclasses.asdict(JARCHS[name])
    assert (dataclasses.asdict(ARCHS[name].smoke())
            == dataclasses.asdict(JARCHS[name].smoke()))
    assert ARCHS[name].resolved_head_dim == JARCHS[name].resolved_head_dim


def test_param_count_equals_reference():
    for name in DENSE:
        assert (tmodel.param_count(get_arch(name))
                == jmodel.param_count(JARCHS[name]))
    n = tmodel.param_count(get_arch("phi3-mini-3.8b"))
    assert 3.8e9 < n < 3.85e9, n


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def test_rms_norm_rope_mlp_match_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, 3, 16).astype(np.float32)
    w = rng.randn(16).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        tlayers.rms_norm(_t(x), _t(w), 1e-6).numpy(),
        _np(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        **LAYER_TOL)
    pos = (rng.randint(0, 500, (2, 7))).astype(np.int32)
    np.testing.assert_allclose(
        tlayers.rope(_t(x), _t(pos), 10000.0).numpy(),
        _np(jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)),
        **LAYER_TOL)
    p = jlayers.init_mlp(jax.random.PRNGKey(1), 16, 24, jnp.float32)
    m = tlayers.MLP(16, 24, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for k in p:
            getattr(m, k).copy_(_t(p[k]))
        got = m(_t(x[:, :, 0])).numpy()
    np.testing.assert_allclose(got, _np(jlayers.mlp(p, jnp.asarray(
        x[:, :, 0]))), **LAYER_TOL)


def _kv_case(seed, B=2, S=10, T=14, H=4, Kv=2, Dh=16):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, S, H, Dh).astype(np.float32)
    k = rng.randn(B, T, Kv, Dh).astype(np.float32)
    v = rng.randn(B, T, Kv, Dh).astype(np.float32)
    mask = rng.rand(B, 1, S, T) < 0.7
    mask[..., 0] = True
    return q, k, v, mask


def test_sdpa_and_q_chunked_match_reference():
    q, k, v, mask = _kv_case(1)
    want = _np(jlayers._sdpa(*map(jnp.asarray, (q, k, v, mask))))
    got = tlayers._sdpa(*map(_t, (q, k, v, mask))).numpy()
    np.testing.assert_allclose(got, want, **LAYER_TOL)
    for chunk in (3, 4, 10):
        want = _np(jlayers._sdpa_q_chunked(*map(jnp.asarray, (q, k, v, mask)),
                                           chunk))
        got = tlayers._sdpa_q_chunked(*map(_t, (q, k, v, mask)),
                                      chunk).numpy()
        np.testing.assert_allclose(got, want, **LAYER_TOL)


@pytest.mark.parametrize("case", ["flash", "sdpa", "chunked", "window",
                                  "cache"])
def test_attention_matches_reference(case):
    B, S, D, H, Kv, Dh = 2, 12, 32, 4, 2, 16
    p = jlayers.init_attention(jax.random.PRNGKey(2), D, H, Kv, Dh,
                               qkv_bias=True, dtype=jnp.float32)
    rng = np.random.RandomState(3)
    p = {k: (v if not k.startswith("b")
             else jnp.asarray(rng.randn(*v.shape).astype(np.float32) * 0.1))
         for k, v in p.items()}
    a = tlayers.Attention(D, H, Kv, Dh, qkv_bias=True, dtype=torch.float32,
                          device="cpu")
    with torch.no_grad():
        for k in p:
            getattr(a, k).copy_(_t(p[k]))
    x = rng.randn(B, S, D).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    kw = dict(causal=True, window=0, rope_theta=10000.0)
    if case == "cache":        # S=1 query against a half-filled cache
        T = 20
        kvpos = np.full((B, T), -1, np.int32)
        kvpos[:, :S] = pos
        qpos = pos[:, -1:]
        x = x[:, -1:]
        kc = rng.randn(B, T, Kv, Dh).astype(np.float32)
        vc = rng.randn(B, T, Kv, Dh).astype(np.float32)
    else:
        kvpos, qpos = pos, pos
        kc, vc = (_np(t) for t in jlayers.project_kv(
            p, jnp.asarray(x), jnp.asarray(pos), 10000.0))
        tk, tv = tlayers.project_kv(a, _t(x), _t(pos), 10000.0)
        np.testing.assert_allclose(tk.detach().numpy(), kc, **LAYER_TOL)
        np.testing.assert_allclose(tv.detach().numpy(), vc, **LAYER_TOL)
    jkw, tkw = dict(kw), dict(kw)
    if case == "flash":
        jkw["use_flash"] = tkw["use_flash"] = True
    if case == "chunked":
        jkw["q_chunk"] = tkw["q_chunk"] = 5
    if case == "window":
        jkw["window"] = tkw["window"] = 4
    want = jlayers.attention(p, jnp.asarray(x), positions=jnp.asarray(qpos),
                             kv_positions=jnp.asarray(kvpos),
                             k_cache=jnp.asarray(kc), v_cache=jnp.asarray(vc),
                             **jkw)
    tfa.reset_launch_counts()
    got = tlayers.attention(a, _t(x), positions=_t(qpos),
                            kv_positions=_t(kvpos), k_cache=_t(kc),
                            v_cache=_t(vc), **tkw)
    assert tfa.launch_counts()["flash_attention"] == 0
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **LAYER_TOL)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,flash", [("phi3-mini-3.8b", True),
                                        ("phi3-mini-3.8b", False),
                                        ("qwen1.5-32b", True),
                                        ("command-r-plus-104b", True)])
def test_forward_train_matches_reference(name, flash):
    """phi3 with and without the flash branch; qwen (QKV bias) and
    command-r (tied embeddings) with it."""
    cfg, params = _jax_model(name, flash)
    model = _port_model(name, params, flash)
    B, S = 2, 40
    toks = np.random.RandomState(4).randint(0, cfg.vocab_size, (B, S))
    want, _ = jmodel.forward(cfg, params, {"tokens": jnp.asarray(toks)},
                             mode="train", dtype=jnp.float32)
    tfa.reset_launch_counts()
    got, aux = model({"tokens": torch.from_numpy(toks)}, mode="train")
    assert tfa.launch_counts() == {"flash_attention": 0}   # plain on CPU
    assert got.shape == (B, S, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), _np(want), **LOGIT_TOL)


def test_flash_branch_runs_the_kernel_wrapper(monkeypatch):
    """With use_flash_attention every layer's attention goes through the
    kernel's wrapper (on the card, one launch per layer); without it none
    does."""
    calls = []
    real = tlayers.flash_attention
    monkeypatch.setattr(tlayers, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for flash in (True, False):
        cfg, params = _jax_model("phi3-mini-3.8b", flash)
        model = _port_model("phi3-mini-3.8b", params, flash)
        calls.clear()
        model({"tokens": torch.zeros(1, 8, dtype=torch.long)})
        assert len(calls) == (cfg.num_layers if flash else 0)


def test_prefill_decode_match_reference():
    """Prefill, then decode teacher-forced on the reference's greedy
    tokens: logits per step; then greedy_generate's tokens."""
    name = "phi3-mini-3.8b"
    cfg, params = _jax_model(name)
    model = _port_model(name, params)
    B, S, steps, max_seq = 2, 12, 6, 24
    prompt = np.random.RandomState(5).randint(0, cfg.vocab_size, (B, S))
    jcache = jmodel.init_cache(cfg, B, max_seq, dtype=jnp.float32)
    tcache = tmodel.init_cache(model.cfg, B, max_seq, dtype=torch.float32,
                               device="cpu")
    jl, jcache = jmodel.forward(cfg, params, {"tokens": jnp.asarray(prompt)},
                                mode="prefill", cache=jcache,
                                dtype=jnp.float32)
    tl, tcache = tserve.make_prefill_step(model)(
        {"tokens": torch.from_numpy(prompt)}, tcache)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **LOGIT_TOL)
    decode = tserve.make_decode_step(model)
    jtoks = [np.asarray(jnp.argmax(jl, -1))[:, None]]
    for _ in range(steps - 1):
        jl, jcache = jmodel.forward(cfg, params,
                                    {"tokens": jnp.asarray(jtoks[-1])},
                                    mode="decode", cache=jcache,
                                    dtype=jnp.float32)
        tl, tcache = decode(_t(jtoks[-1]), tcache)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **LOGIT_TOL)
        jtoks.append(np.asarray(jnp.argmax(jl, -1))[:, None])
    assert tcache["pos"] == int(jcache["pos"]) == S + steps - 1
    np.testing.assert_array_equal(tcache["gpos"].numpy(),
                                  np.asarray(jcache["gpos"]))
    np.testing.assert_allclose(tcache["gk"].numpy(), _np(jcache["gk"]),
                               **LOGIT_TOL)
    want = np.asarray(jserve.greedy_generate(cfg, params, jnp.asarray(prompt),
                                             steps, max_seq))
    got = tserve.greedy_generate(model, torch.from_numpy(prompt), steps,
                                 max_seq)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.concatenate(jtoks, axis=1))


@pytest.mark.parametrize("name", DENSE)
def test_serving_consistent_with_train(name):
    """The port's own check, as test_models_smoke.py's: prefill of S-1
    tokens and one decode step reproduce the train pass's last logits."""
    cfg = get_arch(name).smoke()
    gen = torch.Generator().manual_seed(0)
    model = tmodel.init_params(cfg, generator=gen, dtype=torch.float32,
                               device="cpu")
    B, S = 2, 24
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    tlog, _ = model({"tokens": toks})
    cache = tmodel.init_cache(cfg, B, S + 8, torch.float32, "cpu")
    plog, cache = model({"tokens": toks[:, :S - 1]}, mode="prefill",
                        cache=cache)
    dlog, cache = model({"tokens": toks[:, S - 1:]}, mode="decode",
                        cache=cache)
    np.testing.assert_allclose(plog.numpy(), tlog[:, S - 2].numpy(),
                               atol=3e-4, rtol=1e-3)
    np.testing.assert_allclose(dlog.numpy(), tlog[:, S - 1].numpy(),
                               atol=3e-4, rtol=1e-3)


def test_serve_cli_runs_on_cpu(capsys):
    tlaunch.main(["--arch", "phi3-mini-3.8b", "--smoke", "--device", "cpu",
                  "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert "[serve] arch=phi3-mini-3.8b device=cpu batch=2" in out
    assert "sample:" in out


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

def test_no_card_raises_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_arch("phi3-mini-3.8b").smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "phi3-mini-3.8b", "--smoke"])


@pytest.mark.parametrize("name,item", [
    ("gemma3-27b", "item 16"), ("deepseek-moe-16b", "item 17"),
    ("llama4-scout-17b-a16e", "item 17"), ("xlstm-350m", "item 18"),
    ("recurrentgemma-9b", "item 19"), ("hubert-xlarge", "item 20"),
    ("llava-next-mistral-7b", "item 20")])
def test_unported_configs_raise(name, item):
    cfg = get_arch(name).smoke()
    with pytest.raises(NotImplementedError, match=f"queue 1, {item}\\)"):
        tmodel.Model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=f"queue 1, {item}\\)"):
        tmodel.param_count(get_arch(name))


def test_unported_options_raise():
    cfg, params = _jax_model("phi3-mini-3.8b")
    model = _port_model("phi3-mini-3.8b", params)
    with pytest.raises(NotImplementedError, match="queue 1, item 13"):
        model({"tokens": torch.zeros(1, 4, dtype=torch.long)},
              act_sharding=object())
    with pytest.raises(NotImplementedError, match="queue 1, item 13"):
        tserve.make_sharded_decode_step(cfg, None, 1, 8)
    cache = tmodel.init_cache(model.cfg, 1, 8, torch.float32, "cpu")
    with pytest.raises(ValueError, match="cache full"):
        model({"tokens": torch.zeros(1, 9, dtype=torch.long)},
              mode="prefill", cache=cache)
    with pytest.raises(ValueError, match="do not fit"):
        tserve.greedy_generate(model, torch.zeros(1, 6, dtype=torch.long),
                               4, 8)
