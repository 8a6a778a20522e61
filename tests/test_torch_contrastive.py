"""The PyTorch port's contrastive stack against the JAX package's, on the
CPU in f32: the CLIP tokenizer (exact ids), the text tower and ActionCLIP's
forwards (2e-5), the contrastive train step with and without MoCo on a
batch with a padded row against the JAX ``make_contrastive_train_step``
under plain SGD (loss, temperature, every leaf and the momentum weights
after two steps: rtol 1e-4 / atol 1e-5), and the retrieval metrics
(exact). Weights: the port's draw from a seed plus numpy noise, carried to
the JAX package (``torch_port_helpers.clip_params_to_jax``)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.data import tokenizer as jtok
from aicity_action_tpu.engine import contrastive as jcon
from aicity_action_tpu.models.build import build_module
from aicity_action_tpu.models.text import TextTransformer as JaxText
from aicity_action_tpu_torch.config import (actionclip_mvitv2_b_16x4_448_cfg,
                                            get_cfg)
from aicity_action_tpu_torch.data import tokenizer as ttok
from aicity_action_tpu_torch.engine import contrastive as tcon
from aicity_action_tpu_torch.models.build import build_model
from aicity_action_tpu_torch.models.text import TextTransformer
from aicity_action_tpu_torch.solver.optimizer import TrainOptimizer
from aicity_action_tpu_torch.utils.convert import (
    jax_actionclip_to_state_dict, jax_actionclip_tree_to_named)
from torch_port_helpers import (YAML, clip_params_to_jax, perturb,
                                tiny_clip_cfg, write_merges)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

TOL = 2e-5
RTOL, ATOL = 1e-4, 1e-5

TEXTS = ["Hello world", "a person drinking, then texting on the phone!",
         "EATING and   reaching 42 times", "caf&eacute; &amp; the car's",
         "hello", ""]


def test_actionclip_config_equals_the_jax_config_with_its_overrides():
    want = jax_get_cfg()
    want.merge_from_file(YAML)
    want.MODEL.MODEL_NAME = "ActionCLIP"
    want.CONTRA.ENABLE = True
    want.TRAIN.DATASET = "web_video_text"
    want.TEST.DATASET = "web_video_text"
    got = actionclip_mvitv2_b_16x4_448_cfg().to_dict()
    want = want.to_dict()
    # the port's process-group keys have no counterpart in the JAX config
    assert set(got) - set(want) == {"INIT_METHOD"}
    assert {k: got[k] for k in want} == want
    c = actionclip_mvitv2_b_16x4_448_cfg().CONTRA
    assert (c.transformer_width, c.transformer_layers, c.transformer_heads,
            c.CONTEXT_LENGTH, c.vocab_size, c.embed_dim, c.use_MLP) == \
        (512, 12, 8, 77, 49408, 512, False)


@pytest.fixture(scope="module")
def merges(tmp_path_factory):
    return write_merges(tmp_path_factory.mktemp("bpe") / "merges.txt")


@pytest.mark.parametrize("context", [77, 8])
def test_tokenizer_ids_equal_the_jax_tokenizer(merges, context):
    got_tok, want_tok = ttok.SimpleTokenizer(merges), \
        jtok.SimpleTokenizer(merges)
    for text in TEXTS:
        assert got_tok.encode(text) == want_tok.encode(text)
        assert got_tok.decode(got_tok.encode(text)) == \
            want_tok.decode(want_tok.encode(text))
    got = ttok.tokenize(got_tok, TEXTS, context)
    want = jtok.tokenize(want_tok, TEXTS, context)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    eot = got_tok.encoder["<|endoftext|>"]
    # the end-of-text id is the vocabulary's largest, and ends every row
    assert eot == max(got_tok.encoder.values())
    assert all(eot in row for row in got)


def _tokens(rng, batch, ctx=8, vocab=64):
    """Token rows as the tokenizer writes them: ids below the EOT id, the
    EOT id (the largest), then zero padding."""
    tok = rng.integers(1, vocab - 1, (batch, ctx))
    for i in range(batch):
        end = int(rng.integers(2, ctx))
        tok[i, end] = vocab - 1
        tok[i, end + 1:] = 0
    return tok


@pytest.mark.parametrize("use_mlp", [False, True])
def test_text_tower_matches_jax(use_mlp):
    torch.manual_seed(0)
    model = TextTransformer(width=32, layers=2, heads=2, context_length=8,
                            vocab_size=64, embed_dim=16, use_mlp=use_mlp,
                            compute_dtype=torch.float32)
    model.init_weights(torch.Generator().manual_seed(3))
    sd = {"text_encoder." + k: v for k, v in model.state_dict().items()}
    sd["logit_scale"] = torch.tensor(0.0)
    params = perturb(clip_params_to_jax(sd)["text_encoder"], 5)
    model.load_state_dict({k[len("text_encoder."):]: v for k, v in
                           jax_actionclip_to_state_dict(
                               {"text_encoder": params,
                                "logit_scale": 0.0}).items()
                           if k != "logit_scale"})
    tokens = _tokens(np.random.default_rng(1), 3)
    want = jax.jit(JaxText(width=32, layers=2, heads=2, context_length=8,
                           vocab_size=64, embed_dim=16,
                           use_mlp=use_mlp).apply)(
        {"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def _models(seed, use_mlp=False):
    """The JAX ActionCLIP module and numpy params, and the port's model on
    the CPU with the same weights."""
    module, _ = build_module(tiny_clip_cfg(jax_get_cfg, use_mlp))
    model = build_model(tiny_clip_cfg(get_cfg, use_mlp), device="cpu",
                        seed=seed)
    params = perturb(clip_params_to_jax(model.state_dict()), seed + 1)
    model.load_state_dict(jax_actionclip_to_state_dict(params), strict=True)
    return module, params, model


def _clips(rng, batch):
    return rng.standard_normal((batch, 4, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("use_mlp", [False, True])
def test_actionclip_forward_matches_jax(use_mlp):
    module, params, model = _models(0, use_mlp)
    rng = np.random.default_rng(2)
    x, tokens = _clips(rng, 3), _tokens(rng, 3)
    v, t, s = jax.jit(module.apply)({"params": params}, [jnp.asarray(x)],
                                    jnp.asarray(tokens))
    with torch.no_grad():
        gv, gt, gs = model([torch.from_numpy(x)], torch.from_numpy(tokens))
    np.testing.assert_allclose(gv.numpy(), np.asarray(v), atol=TOL, rtol=0)
    np.testing.assert_allclose(gt.numpy(), np.asarray(t), atol=TOL, rtol=0)
    np.testing.assert_allclose(float(gs), float(s), rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(gv.numpy(), axis=-1), 1.0,
                               rtol=1e-5)


def test_text_only_model_builds_without_the_video_tower():
    cfg = tiny_clip_cfg(get_cfg)
    cfg.MODEL.LOAD_VISUAL = False
    model = build_model(cfg, device="cpu")
    assert model.video_encoder is None
    assert not any(k.startswith("video_encoder") for k in model.state_dict())
    assert float(model.logit_scale) == pytest.approx(np.log(1 / 0.07))
    with pytest.raises(ValueError, match="LOAD_VISUAL"):
        model.encode_video(torch.zeros(1, 4, 32, 32, 3))


LR = 0.5
MOMENTUM = 0.9


@pytest.mark.parametrize("use_moco", [False, True])
def test_train_step_matches_jax(use_moco):
    module, params, model = _models(4)
    rng = np.random.default_rng(6)
    B = 4
    batch = {"inputs": _clips(rng, B), "tokens": _tokens(rng, B),
             "labels": np.asarray([0, 1, 0, 2])}
    n_valid = 3  # the last row pads the batch

    tx = optax.sgd(LR)
    state = jcon.ContrastiveState.create(
        jax.tree_util.tree_map(jnp.asarray, params), tx, use_moco=use_moco)
    jstep = jax.jit(jcon.make_contrastive_train_step(
        module, tx, use_moco=use_moco, moco_momentum=MOMENTUM))
    jbatch = {"inputs": [jnp.asarray(batch["inputs"])],
              "tokens": jnp.asarray(batch["tokens"]),
              "labels": jnp.asarray(batch["labels"]),
              "n_valid": jnp.int32(n_valid)}
    want = []
    for _ in range(2):
        state, metrics, _ = jstep(state, jbatch, jax.random.PRNGKey(0))
        want.append((float(metrics["loss"]), float(metrics["logit_scale"])))

    opt = TrainOptimizer(torch.optim.SGD(model.parameters(), lr=LR),
                         lambda step: LR)
    momentum = tcon.make_momentum_model(model) if use_moco else None
    step = tcon.make_contrastive_train_step(
        model, opt, use_moco=use_moco, moco_momentum=MOMENTUM,
        momentum_model=momentum)
    tbatch = {"inputs": torch.from_numpy(batch["inputs"]),
              "tokens": torch.from_numpy(batch["tokens"]),
              "labels": torch.from_numpy(batch["labels"]),
              "n_valid": n_valid}
    got = []
    for _ in range(2):
        metrics, (v, t) = step(tbatch)
        got.append((float(metrics["loss"]), float(metrics["logit_scale"])))
    assert v.shape == t.shape == (B, 16)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got[0][0] > 0 and got[0] != got[1]

    def hold(tree, module_):
        names = jax_actionclip_tree_to_named(
            jax.tree_util.tree_map(np.asarray, tree))
        own = dict(module_.named_parameters())
        assert set(names) == set(own)
        for k, w in names.items():
            np.testing.assert_allclose(own[k].detach().numpy(), w,
                                       rtol=RTOL, atol=ATOL, err_msg=k)

    hold(state.params, model)
    if use_moco:
        hold(state.ema_params, momentum)
        assert not torch.equal(momentum.logit_scale, model.logit_scale)
    assert 0.0 <= float(model.logit_scale) <= tcon.LOGIT_SCALE_MAX


@pytest.mark.parametrize("start,want", [(5.0, tcon.LOGIT_SCALE_MAX),
                                        (-1.0, 0.0)])
def test_logit_scale_is_clamped_after_the_update(start, want):
    _, _, model = _models(7)
    with torch.no_grad():
        model.logit_scale.fill_(start)
    opt = TrainOptimizer(torch.optim.SGD(model.parameters(), lr=1e-6),
                         lambda step: 1e-6)
    step = tcon.make_contrastive_train_step(model, opt)
    rng = np.random.default_rng(8)
    metrics, _ = step({"inputs": torch.from_numpy(_clips(rng, 2)),
                       "tokens": torch.from_numpy(_tokens(rng, 2)),
                       "labels": torch.tensor([0, 1])})
    # the step used exp(start); the update is clamped to [0, ln 100]
    assert float(metrics["logit_scale"]) == pytest.approx(np.exp(start))
    assert float(model.logit_scale) == pytest.approx(want)


def test_gt_matrix_and_retrieval_metrics_equal_jax():
    rng = np.random.default_rng(9)
    labels = np.asarray([0, 1, 0, 2, 3, 3, 1, 4, 5, 6, 7, 8])
    valid = np.arange(12) < 10
    got = tcon.contrastive_gt_matrix(torch.from_numpy(labels),
                                     torch.from_numpy(valid)).numpy()
    want = np.asarray(jcon.contrastive_gt_matrix(jnp.asarray(labels),
                                                 jnp.asarray(valid)))
    assert np.array_equal(got, want)
    for _ in range(3):
        v = rng.standard_normal((12, 8)).astype(np.float32)
        t = rng.standard_normal((12, 8)).astype(np.float32)
        assert tcon.retrieval_metrics(v, t, labels) == \
            jcon.retrieval_metrics(v, t, labels)
        simi = v @ t.T
        gt = (labels[:, None] == labels[None]).astype(np.float32)
        for ks in ((1,), (1, 5, 10), (2, 3)):
            assert tcon.recall_at_rank(simi, gt, ks) == \
                jcon.recall_at_rank(simi, gt, ks)
