"""PyTorch port: HF interop (`horovod_tpu_torch.compat.hf`) against the
HF models themselves and against the JAX package's `compat.hf`.

Every HF model is built offline from a tiny config written here, with
the installed `transformers` and its random init from a torch seed:
GPT-2, LLaMA (GQA 4:2), Mistral (a sliding window the sequences
exceed), Qwen2 (q/k/v biases, 7 query heads on 1 kv head) and Gemma-1
(head_dim 256, 2 query heads on 1 kv head). Each family is held three
ways: the port's import against the HF model's logits, against the JAX
package's import run with ``attn_impl="flash"`` (the Pallas kernels in
interpret mode, as tests/test_hf_compat.py runs them) and against the
JAX model's greedy decode; and through the weights carried across, the
JAX tree -> `params_from_jax` -> the port. Tolerances: float32 on every
side, so logits agree to 1e-5 (atol and rtol; summation order and the
norms' association order only); greedy streams are token-exact.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

transformers = pytest.importorskip("transformers")

from horovod_tpu.compat import hf as jhf  # noqa: E402
from horovod_tpu.models import transformer as jt  # noqa: E402
from horovod_tpu_torch.compat import hf as thf  # noqa: E402
from horovod_tpu_torch.compat.from_jax import params_from_jax  # noqa: E402
from horovod_tpu_torch.models import transformer as tt  # noqa: E402

TOL = 1e-5
VOCAB = 97


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Toy shapes gain nothing from intra-op threads, and idle OpenMP
    threads spinning here would slow the JAX tests running beside this
    module in other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# family -> (HF model class, config class, config). Sequences below are
# 20 tokens long, so Mistral's window of 8 truncates.
FAMILIES = {
    "gpt2": ("GPT2LMHeadModel", "GPT2Config", dict(
        n_embd=32, n_layer=2, n_head=2, n_positions=64,
        vocab_size=VOCAB, resid_pdrop=0.0, embd_pdrop=0.0,
        attn_pdrop=0.0)),
    "llama": ("LlamaForCausalLM", "LlamaConfig", dict(
        hidden_size=32, intermediate_size=88, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, vocab_size=VOCAB,
        rope_theta=10000.0, attention_dropout=0.0)),
    "mistral": ("MistralForCausalLM", "MistralConfig", dict(
        hidden_size=32, intermediate_size=88, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, vocab_size=VOCAB, sliding_window=8,
        attention_dropout=0.0)),
    "qwen2": ("Qwen2ForCausalLM", "Qwen2Config", dict(
        hidden_size=56, intermediate_size=88, num_hidden_layers=2,
        num_attention_heads=7, num_key_value_heads=1,
        max_position_embeddings=64, vocab_size=VOCAB,
        rope_theta=1e6, attention_dropout=0.0,
        use_sliding_window=False)),
    "gemma": ("GemmaForCausalLM", "GemmaConfig", dict(
        hidden_size=512, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, head_dim=256,
        max_position_embeddings=64, vocab_size=VOCAB,
        rope_theta=10000.0, attention_dropout=0.0,
        hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True)),
}
SEED = {f: i for i, f in enumerate(sorted(FAMILIES))}


def _hf(family, seed=0, **over):
    cls, cfg_cls, cfg = FAMILIES[family]
    torch.manual_seed(seed)
    cfg = getattr(transformers, cfg_cls)(**dict(cfg, **over))
    return getattr(transformers, cls)(cfg).eval()


@pytest.fixture(scope="module")
def models():
    """family -> (HF model, port model, JAX model, JAX params), f32."""
    out = {}
    for fam in FAMILIES:
        hf = _hf(fam, seed=10 + SEED[fam])
        ours = getattr(thf, f"from_hf_{fam}")(
            hf, dtype=torch.float32, device="cpu")
        jm, jp = getattr(jhf, f"from_hf_{fam}")(hf, dtype=jnp.float32,
                                                attn_impl="flash")
        out[fam] = (hf, ours, jm, jp)
    return out


def _tokens(family, B=2, S=20):
    return np.random.RandomState(30 + SEED[family]).randint(0, VOCAB,
                                                            (B, S))


def _port_logits(model, toks):
    with torch.no_grad():
        return model(torch.from_numpy(toks)).numpy()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_logits_match_hf_model(models, family):
    hf, ours, _, _ = models[family]
    toks = _tokens(family)
    with torch.no_grad():
        want = hf(torch.from_numpy(toks)).logits.numpy()
    assert ours.attn_impl == "flash"
    np.testing.assert_allclose(_port_logits(ours, toks), want, atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_logits_match_jax_import(models, family):
    """The port's import and the JAX package's import of the same HF
    model, both on their flash path (JAX: Pallas in interpret mode)."""
    _, ours, jm, jp = models[family]
    toks = _tokens(family)
    want = np.asarray(jm.apply({"params": jp}, jnp.asarray(toks)))
    np.testing.assert_allclose(_port_logits(ours, toks), want, atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_jax_tree_carried_across_equals_hf_import(models, family):
    """HF -> the JAX package -> `params_from_jax` -> the port is the
    same model as HF -> the port, weight for weight."""
    _, ours, _, jp = models[family]
    sd = params_from_jax(jax.tree.map(np.asarray, jp))
    mine = ours.state_dict()
    assert sorted(sd) == sorted(mine)
    for k in mine:
        assert torch.equal(sd[k].float(), mine[k]), k


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_greedy_decode_matches_jax(models, family):
    hf, ours, jm, jp = models[family]
    prompt = _tokens(family, S=6)
    steps = 10        # Mistral's generation crosses its window of 8
    want = np.asarray(jt.generate(jm, jp, jnp.asarray(prompt), steps))
    got = tt.generate(ours, torch.from_numpy(prompt), steps).numpy()
    np.testing.assert_array_equal(got, want)
    with torch.no_grad():   # no stop token: HF would pad after its eos
        theirs = hf.generate(torch.from_numpy(prompt), max_new_tokens=steps,
                             do_sample=False, pad_token_id=0,
                             eos_token_id=None).numpy()
    np.testing.assert_array_equal(got, theirs)


def test_model_properties_follow_the_family(models):
    assert models["mistral"][1].window == 8
    q = models["qwen2"][1]
    assert q.attn_bias and q.attn_out_bias is False and q.window is None
    assert "blocks.0.attn.qkv.bias" in q.state_dict()
    assert "blocks.0.attn.out.bias" not in q.state_dict()
    g = models["gemma"][1]
    assert (g.mlp_impl, g.tied_head, g.head_dim, g.num_kv) == (
        "geglu", True, 256, 1)
    assert g.embed_scale == pytest.approx(512 ** 0.5)
    assert "lm_head" not in g.state_dict()
    assert models["llama"][1].lm_head is not None


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_state_dict_path_equals_model_path(models, family):
    """`from_hf_state_dict` on (config dict, HF state dict) — the path
    the card takes, without `transformers` — builds the model path's
    weights bit for bit, also from numpy arrays and without the base
    model's key prefix."""
    hf, ours, _, _ = models[family]
    cfg = hf.config.to_dict()
    flat = {k.split(".", 1)[1] if k.startswith(("model.", "transformer."))
            else k: v.numpy() for k, v in hf.state_dict().items()}
    for sd in (hf.state_dict(), flat):
        m = thf.from_hf_state_dict(family, cfg, sd, dtype=torch.float32,
                                   device="cpu")
        for k, v in ours.state_dict().items():
            assert torch.equal(m.state_dict()[k], v), k


@pytest.mark.parametrize("family", ["gpt2", "llama", "qwen2", "gemma"])
def test_export_round_trip(models, family):
    """port -> `to_hf_*` into a FRESH shell (other random weights) ->
    the shell computes the port model's logits; and re-importing the
    shell gives the same weights back."""
    hf, ours, _, _ = models[family]
    export = {"gpt2": thf.to_hf_gpt2, "gemma": thf.to_hf_gemma}.get(
        family, thf.to_hf_llama)
    shell = export(ours, _hf(family, seed=99))
    toks = _tokens(family)
    with torch.no_grad():
        theirs = shell(torch.from_numpy(toks)).logits.numpy()
    np.testing.assert_allclose(theirs, _port_logits(ours, toks), atol=TOL,
                               rtol=TOL)
    back = getattr(thf, f"from_hf_{family}")(shell, dtype=torch.float32,
                                             device="cpu")
    for k, v in ours.state_dict().items():
        torch.testing.assert_close(back.state_dict()[k], v, atol=1e-6,
                                   rtol=0)


def test_export_of_trained_weights_and_bf16_model():
    """A port model with its own random init (not an import) exports
    and computes the same function in HF; a bf16 model exports too."""
    ours = thf.from_hf_llama(_hf("llama", seed=3), dtype=torch.float32,
                             device="cpu")
    ours.init_weights(5)
    shell = thf.to_hf_llama(ours, _hf("llama", seed=4))
    toks = _tokens("llama")
    with torch.no_grad():
        theirs = shell(torch.from_numpy(toks)).logits.numpy()
    np.testing.assert_allclose(theirs, _port_logits(ours, toks), atol=TOL,
                               rtol=TOL)
    bf = thf.from_hf_gpt2(_hf("gpt2", seed=5), device="cpu")
    bf.to(torch.bfloat16)
    out = thf.to_hf_gpt2(bf, _hf("gpt2", seed=6))
    with torch.no_grad():
        assert torch.isfinite(out(torch.from_numpy(toks)).logits).all()


# (name, family of the model the call is made on, its config overrides,
# what is called, the error text both packages give). "import" calls
# from_hf_<family>; the export cases call the exporter on an import of
# a clean model of that family into the shell that the overrides build.
REJECTIONS = [
    ("gpt2 relu", "gpt2", dict(activation_function="relu"), "import",
     "activation"),
    ("gpt2 exact gelu", "gpt2", dict(activation_function="gelu"),
     "import", "activation"),
    ("gpt2 scale_attn_weights", "gpt2", dict(scale_attn_weights=False),
     "import", "scale_attn_weights"),
    ("gpt2 n_inner", "gpt2", dict(n_inner=48), "import", "n_inner"),
    ("llama hidden_act", "llama", dict(hidden_act="gelu"), "import",
     "hidden_act"),
    ("llama o_proj bias", "llama", dict(attention_bias=True), "import",
     "o_proj bias"),
    ("llama rope_scaling", "llama",
     dict(rope_scaling={"rope_type": "linear", "factor": 2.0}), "import",
     "rope_scaling"),
    ("llama mlp_bias", "llama", dict(mlp_bias=True), "import", "mlp_bias"),
    ("llama head_dim", "llama", dict(head_dim=16), "import", "head_dim"),
    ("qwen2 sliding window", "qwen2",
     dict(use_sliding_window=True, sliding_window=8, max_window_layers=1),
     "import", "use_sliding_window"),
    ("gemma widened heads", "gemma", dict(head_dim=128), "import",
     "head_dim"),
    ("gemma hidden_act gelu", "gemma", dict(hidden_act="gelu"), "import",
     "gelu_pytorch_tanh"),
    ("gemma hidden_activation gelu", "gemma",
     dict(hidden_activation="gelu"), "import", "gelu_pytorch_tanh"),
    ("gemma untied", "gemma", dict(tie_word_embeddings=False), "import",
     "untied"),
    ("gpt2 export into a shell of other depth", "gpt2", dict(n_layer=1),
     "export", "does not match"),
    ("qwen2 export into a biasless shell", "qwen2", dict(), "export_llama",
     "qkv bias"),
    ("gemma export into an exact-gelu shell", "gemma",
     dict(hidden_act="gelu"), "export", "gelu_pytorch_tanh"),
    ("gemma export into a llama shell", "gemma", dict(), "export_llama",
     "model_type"),
    ("gemma export of a llama model", "llama", dict(), "export_gemma",
     "geglu"),
    ("gemma export with another embed_scale", "gemma", dict(),
     "export_rescaled", "embed_scale"),
]


def _shell_for(family, how, over):
    if how == "export":
        return _hf(family, seed=7, **over)
    if how == "export_llama" and family == "qwen2":
        return _hf("llama", seed=7, hidden_size=56, num_attention_heads=7,
                   num_key_value_heads=1)
    if how == "export_llama":      # a LLaMA shell of Gemma's geometry
        return _hf("llama", seed=7, hidden_size=512, intermediate_size=64,
                   num_attention_heads=2, num_key_value_heads=1,
                   head_dim=256, hidden_act="gelu_pytorch_tanh",
                   tie_word_embeddings=True)
    return _hf("gemma", seed=7)


def _reject_port(family, over, how):
    if how == "import":
        getattr(thf, f"from_hf_{family}")(_hf(family, **over), device="cpu",
                                          dtype=torch.float32)
        return
    ours = getattr(thf, f"from_hf_{family}")(_hf(family),
                                             dtype=torch.float32,
                                             device="cpu")
    shell = _shell_for(family, how, over)
    if how == "export_rescaled":
        ours.embed_scale = 1.0
    if how in ("export_gemma", "export_rescaled") or (
            how == "export_llama" and family == "gemma") or (
            how == "export" and family == "gemma"):
        thf.to_hf_gemma(ours, shell)
    elif family == "gpt2":
        thf.to_hf_gpt2(ours, shell)
    else:
        thf.to_hf_llama(ours, shell)


def _reject_jax(family, over, how):
    if how == "import":
        getattr(jhf, f"from_hf_{family}")(_hf(family, **over))
        return
    jm, jp = getattr(jhf, f"from_hf_{family}")(_hf(family),
                                               dtype=jnp.float32)
    shell = _shell_for(family, how, over)
    if how == "export_rescaled":
        jm = jm.clone(embed_scale=1.0)
    if how in ("export_gemma", "export_rescaled") or (
            how == "export_llama" and family == "gemma") or (
            how == "export" and family == "gemma"):
        jhf.to_hf_gemma(jm, jp, shell)
    elif family == "gpt2":
        jhf.to_hf_gpt2(jm, jp, shell)
    else:
        jhf.to_hf_llama(jm, jp, shell)


@pytest.mark.parametrize("name,family,over,how,match", REJECTIONS,
                         ids=[r[0] for r in REJECTIONS])
def test_rejects_what_the_reference_rejects(name, family, over, how, match):
    """Every rejection of tests/test_hf_compat.py (and the config knobs
    `compat/hf.py` rejects besides), through both packages with the
    same message."""
    with pytest.raises(ValueError, match=match):
        _reject_jax(family, over, how)
    with pytest.raises(ValueError, match=match):
        _reject_port(family, over, how)


def test_clean_non_4x_mlp_ratio_converts():
    hf = _hf("gpt2", seed=5, n_inner=64)
    ours = thf.from_hf_gpt2(hf, dtype=torch.float32, device="cpu")
    assert ours.mlp_ratio == 2
    toks = _tokens("gpt2", B=1, S=9)
    with torch.no_grad():
        want = hf(torch.from_numpy(toks)).logits.numpy()
    np.testing.assert_allclose(_port_logits(ours, toks), want, atol=TOL,
                               rtol=TOL)


def test_package_exports_the_reference_names():
    import horovod_tpu.compat as jcompat
    import horovod_tpu_torch.compat as tcompat
    assert set(jcompat.__all__) <= set(tcompat.__all__)
    for name in tcompat.__all__:
        assert getattr(tcompat, name) is getattr(thf, name)


def test_unknown_family_and_default_device():
    with pytest.raises(ValueError, match="family"):
        thf.from_hf_state_dict("bert", {}, {})
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card path is moot")
    with pytest.raises(RuntimeError, match="cuda"):
        thf.from_hf_gpt2(_hf("gpt2"))


def test_gemma_adamw_step_matches_jax(models):
    """Training at head_dim 256: the tiny Gemma config above (2 layers,
    2 heads of 256 over 1 kv head, GeGLU, vocab 97), one HF model's
    weights imported by both packages, one AdamW step each on the same
    int32 token rows (the data pipeline's dtype) with the fused chunked
    loss; the port's flash attention (its plain versions here) against
    the JAX model's dot attention (its Pallas backward at head_dim 256
    is held by test_torch_port_flash.py). Loss and parameters after the
    step
    within 1e-5. AdamW's first update is lr g / (|g| + eps), which
    near |g| ~ eps turns the gradients' last bits into a share of lr:
    at eps 1e-8 the two packages' summation orders moved 7 of 0.5 M
    weights by up to 4e-4, at eps 1e-6 one embedding weight by 2.3e-5
    (lr 1e-2). Both sides take eps 1e-3, where the update is smooth in
    g (at most lr / eps = 10 times a gradient's difference)."""
    import optax
    from horovod_tpu.parallel.mesh import make_mesh
    lr, wd, eps = 1e-2, 1e-4, 1e-3
    hf = models["gemma"][0]
    ours = thf.from_hf_gemma(hf, dtype=torch.float32, device="cpu")
    jm, jp = jhf.from_hf_gemma(hf, dtype=jnp.float32, attn_impl="dot")
    toks = np.random.RandomState(32).randint(0, VOCAB, (2, 20)).astype(
        np.int32)
    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    tx = optax.adamw(lr, eps=eps, weight_decay=wd)
    step = jt.make_lm_train_step(jm, tx, mesh, donate=False, loss_chunk=8)
    jp1, _, jloss = step(jp, tx.init(jp), jnp.asarray(toks))
    opt = torch.optim.AdamW(ours.parameters(), lr=lr, eps=eps,
                            weight_decay=wd)
    tstep = tt.make_lm_train_step(ours, opt, loss_chunk=8)
    with torch.no_grad():
        wide = tt._lm_data_loss(ours, torch.from_numpy(toks).long(), 8)
    tloss = tstep(torch.from_numpy(toks))
    assert float(tloss) == float(wide)          # int32 rows as int64
    np.testing.assert_allclose(float(tloss), float(jloss), atol=TOL,
                               rtol=TOL)
    want = params_from_jax(jax.tree.map(np.asarray, jp1))
    got = ours.state_dict()
    assert sorted(want) == sorted(got)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].float().numpy(),
                                   atol=TOL, rtol=TOL, err_msg=k)
