"""The multi-dataset heads of the port against the JAX package, in f32 on
the CPU: ``compute_multi_dataset_loss`` and VICReg (masked, padded, the
cross projections added to the prediction or as losses of their own)
within 1e-6; ``TransformerMultiHead`` (linear and MLP heads) and the
multi-head tiny MViT-v2's forward within 2e-5; one multi-head SGD train
step (VICReg and the cross projections on, a padded batch) against the
JAX ``make_multihead_train_step``, every gradient within rtol 1e-4 / atol
1e-5; two gloo ranks' step against one process at the global batch; the
cross projections' optimizer group and their ``.npy`` warm start against
the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aicity_action_tpu.config import get_cfg as jax_get_cfg
from aicity_action_tpu.engine import steps as jsteps
from aicity_action_tpu.models import heads as jheads
from aicity_action_tpu.models import losses as jlosses
from aicity_action_tpu.models import mvit as jmvit
from aicity_action_tpu.solver import optimizer as jopt
from aicity_action_tpu.utils import convert as jconvert
from aicity_action_tpu_torch.config import get_cfg
from aicity_action_tpu_torch.engine import steps as tsteps
from aicity_action_tpu_torch.models import heads as theads
from aicity_action_tpu_torch.models import losses as tlosses
from aicity_action_tpu_torch.models.build import build_model
from aicity_action_tpu_torch.solver import optimizer as topt
from aicity_action_tpu_torch.utils import convert as tconvert
from torch_port_helpers import (collect_ranks, multihead_cfg,
                                multihead_params_to_jax, perturb,
                                start_ranks)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

DATASETS = ["kinetics", "mmit", "activitynet"]
NCLS = [7, 5, 4]
LOSSES = ["soft_cross_entropy", "bce_logit", "soft_cross_entropy"]
PAIRS = [(a, b) for a in DATASETS for b in DATASETS if a != b]


def _labels(rng, b, n, multi):
    if multi:
        return (rng.random((b, n)) < 0.4).astype(np.float32)
    return np.eye(n, dtype=np.float32)[rng.integers(0, n, b)]


def _loss_case(seed, b=6):
    rng = np.random.default_rng(seed)
    preds = {ds: rng.standard_normal((b, n)).astype(np.float32)
             for ds, n in zip(DATASETS, NCLS)}
    for src, dst in PAIRS:
        preds[f"{src}_{dst}"] = rng.standard_normal(
            (b, NCLS[DATASETS.index(dst)])).astype(np.float32)
    labels = {ds: _labels(rng, b, n, ds == "mmit")
              for ds, n in zip(DATASETS, NCLS)}
    idx = rng.integers(0, 3, b)
    return preds, labels, idx


@pytest.mark.parametrize("cross,to_pred,padded", [
    (False, False, False), (True, False, False), (True, True, False),
    (True, False, True), (True, True, True)])
def test_multi_dataset_loss_matches_jax(cross, to_pred, padded):
    preds, labels, idx = _loss_case(3)
    b = len(idx)
    n_valid = 4 if padded else None
    valid = (np.arange(b) < (n_valid or b)).astype(np.float32)
    masks = {ds: (idx == i).astype(np.float32) * valid
             for i, ds in enumerate(DATASETS)}
    if not cross:
        preds = {k: v for k, v in preds.items() if k in DATASETS}
    kw = dict(dataset_loss_weights=dict(zip(DATASETS, [1.0, 10.0, 1.0])),
              add_cross_proj=cross, cross_proj_add_to_pred=to_pred,
              proj_loss_func="soft_cross_entropy", proj_loss_weight=0.5)
    want = jlosses.compute_multi_dataset_loss(
        {k: jnp.asarray(v) for k, v in preds.items()},
        {k: jnp.asarray(v) for k, v in labels.items()},
        {k: jnp.asarray(v) for k, v in masks.items()}, DATASETS, LOSSES,
        num_valid=n_valid, **kw)
    got = tlosses.compute_multi_dataset_loss(
        {k: torch.from_numpy(v) for k, v in preds.items()},
        {k: torch.from_numpy(v) for k, v in labels.items()},
        {k: torch.from_numpy(v) for k, v in masks.items()}, DATASETS,
        LOSSES, num_valid=n_valid, **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("valid", [None, 5, 1])
def test_vicreg_matches_jax(valid):
    """Unmasked, a padded batch, and one valid row (the clamped n - 1)."""
    rng = np.random.default_rng(11)
    emb = rng.standard_normal((6, 16)).astype(np.float32)
    mask = None if valid is None else (np.arange(6) < valid).astype(
        np.float32)
    want = jlosses.compute_vicreg_loss(
        jnp.asarray(emb), std_weight=1.0, cov_weight=1.0,
        mask=None if mask is None else jnp.asarray(mask))
    got = tlosses.compute_vicreg_loss(
        torch.from_numpy(emb), std_weight=1.0, cov_weight=1.0,
        mask=None if mask is None else torch.from_numpy(mask))
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("use_mlp", [False, True])
def test_multi_head_matches_jax(use_mlp):
    """Every head and every cross projection, at eval (activations) and in
    training (logits), and one dataset's head alone."""
    acts = ["softmax", "sigmoid", "softmax"]
    jhead = jheads.TransformerMultiHead(
        datasets=DATASETS, num_classes=NCLS, act_funcs=acts,
        use_mlp=use_mlp, add_cross_proj=True)
    x = np.random.default_rng(5).standard_normal((3, 24)).astype(np.float32)
    params = jhead.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        run_cross_proj=True)["params"]
    params = perturb(params, 6)
    head = theads.TransformerMultiHead(24, DATASETS, NCLS, acts,
                                       use_mlp=use_mlp, add_cross_proj=True)
    head.load_state_dict(tconvert.jax_params_to_state_dict(params),
                         strict=True)
    for train in (False, True):
        head.train(train)
        want = jhead.apply({"params": params}, jnp.asarray(x),
                           run_cross_proj=True, train=train)
        with torch.no_grad():
            got = head(torch.from_numpy(x), run_cross_proj=True)
        assert set(got) == set(want) == set(DATASETS) | {
            f"{a}_{b}" for a, b in PAIRS}
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=2e-5, atol=2e-5, err_msg=k)
    # one dataset's head alone: the JAX head raises here under
    # add_cross_proj (it makes the other heads' modules twice), so its
    # scores are held against the all-heads call's
    head.eval()
    want = jhead.apply({"params": params}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = head(torch.from_numpy(x), "mmit")
    assert list(got) == ["mmit"]
    np.testing.assert_allclose(got["mmit"].numpy(), np.asarray(want["mmit"]),
                               rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def pair():
    """The port's tiny multi-head MViT-v2 (seed-0 weights plus noise, so
    that LN scales and biases matter) and the JAX module with the same
    params."""
    model = build_model(multihead_cfg(get_cfg), device="cpu")
    params = perturb(multihead_params_to_jax(model.state_dict()), 2)
    model.load_state_dict(tconvert.jax_params_to_state_dict(params),
                          strict=True)
    jcfg = multihead_cfg(jax_get_cfg)
    module = jmvit.MViT(spec=jmvit.build_mvit_spec(jcfg), dtype=jnp.float32)
    return jcfg, module, params, model


def _batch(seed, b=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 4, 32, 32, 3)).astype(np.float32)
    idx = np.array([0, 1, 2, 1] * (b // 4), np.int64)
    labels = np.zeros((b, max(NCLS)), np.float32)
    for i, d in enumerate(idx):
        labels[i, :NCLS[d]] = _labels(rng, 1, NCLS[d], d == 1)[0]
    return x, labels, idx


def test_multi_head_forward_matches_jax(pair):
    jcfg, module, params, model = pair
    x, _, _ = _batch(1)
    want, want_emb = module.apply({"params": params}, jnp.asarray(x), None,
                                  None, train=False, return_emb=True)
    with torch.no_grad():
        got, emb = model(torch.from_numpy(x), return_emb=True)
    assert set(got) == set(DATASETS)
    for k in DATASETS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-5, atol=2e-5, err_msg=k)
    np.testing.assert_allclose(emb.numpy(), np.asarray(want_emb), rtol=2e-5,
                               atol=2e-5)
    with torch.no_grad():
        one = model(torch.from_numpy(x), dataset_name="activitynet")
    np.testing.assert_allclose(one["activitynet"].numpy(),
                               np.asarray(want["activitynet"]), rtol=2e-5,
                               atol=2e-5)


def _stash_grads():
    """An optax stage that keeps the raw gradients as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def test_multi_head_train_step_matches_jax(pair, x64):
    """One SGD step on a padded batch (3 real rows of 4): the loss and
    every gradient, the heads' and cross projections' included. The trunk
    runs in f64 on both sides (the losses in f32, as both packages compute
    them): at this draw of the tiny widths two correct f32 programs differ
    by up to 14% of a leaf's largest gradient (the JAX package's own f32
    and f64 steps do), while in f64 the port and the JAX package agree
    within 1e-6 of it."""
    jcfg, _, params, model = pair
    module = jmvit.MViT(spec=jmvit.build_mvit_spec(jcfg), dtype=jnp.float64,
                        param_dtype=jnp.float64)
    model = build_model(multihead_cfg(get_cfg), device="cpu")
    model.load_state_dict(tconvert.jax_params_to_state_dict(params))
    model = model.double()
    model.compute_dtype = torch.float64
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                    params)
    x, labels, idx = _batch(4)
    x = x.astype(np.float64)
    m = jcfg.MODEL
    tx = optax.chain(_stash_grads(), optax.sgd(0.1))
    step = jax.jit(jsteps.make_multihead_train_step(
        module, tx, datasets=DATASETS, loss_funcs=LOSSES,
        loss_weights=m.MULTI_LOSS_WEIGHTS, add_cross_proj=True,
        proj_loss_func=m.MULTI_PROJ_LOSS_FUNC,
        proj_loss_weight=m.MULTI_PROJ_LOSS_WEIGHT, use_vicreg=True,
        vicreg_weight=m.VICREG_LOSS_WEIGHT))
    state = jsteps.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, params), tx)
    state, metrics, _ = step(state, {
        "inputs": jnp.asarray(x), "labels": jnp.asarray(labels),
        "dataset_idx": jnp.asarray(idx), "n_valid": jnp.int32(3)},
        jax.random.PRNGKey(0))
    want = tconvert.jax_tree_to_named(jax.tree_util.tree_map(
        np.asarray, state.opt_state[0]))
    opt = topt.TrainOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                              lambda s: 0.1)
    pstep = tsteps.make_multihead_train_step(
        model, opt, **tsteps.multihead_step_kwargs(
            multihead_cfg(get_cfg)))
    got, _ = pstep({"inputs": torch.from_numpy(x),
                    "labels": torch.from_numpy(labels),
                    "dataset_idx": torch.from_numpy(idx), "n_valid": 3})
    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]),
                               rtol=1e-5)
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    for name, g in want.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g, rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    assert np.abs(want["head.cross_kinetics_mmit.weight"]).max() > 1e-4


def test_two_ranks_step_equals_one_process_at_the_global_batch(tmp_path):
    """Two gloo ranks of two rows each (the second with one real row)
    against one process on the four: the global loss, every gradient after
    DDP's average, and the parameters after the step. VICReg's statistics
    are over the global batch's real rows, so a rank that kept only its
    own embedding rows would fail here."""
    cfg = multihead_cfg(get_cfg)
    state = build_model(cfg, device="cpu").state_dict()
    x, labels, idx = _batch(9)
    batch = {"inputs": x, "labels": labels, "dataset_idx": idx,
             "n_valid": 3}
    handle = start_ranks({"kind": "multihead", "cfg": cfg, "state": state,
                          "lr": 0.5, "steps": 1, "batch": batch},
                         tmp_path / "ranks")
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state)
    opt = topt.TrainOptimizer(torch.optim.SGD(model.parameters(), lr=0.5),
                              lambda s: 0.5)
    metrics, _ = tsteps.make_multihead_train_step(
        model, opt, **tsteps.multihead_step_kwargs(cfg))(
        {"inputs": torch.from_numpy(x), "labels": torch.from_numpy(labels),
         "dataset_idx": torch.from_numpy(idx), "n_valid": 3})
    ranks = collect_ranks(handle)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    for r in ranks:
        np.testing.assert_allclose(r["loss"][0], float(metrics["loss"]),
                                   rtol=1e-5)
        assert set(r["grads"]) == set(grads)
        for n, g in grads.items():
            np.testing.assert_allclose(r["grads"][n], g, rtol=1e-4,
                                       atol=1e-6, err_msg=n)
        for n, p in model.named_parameters():
            np.testing.assert_allclose(r["params"][n], p.detach().numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("fix,diff", [(True, False), (False, True),
                                      (True, True), (False, False)])
def test_cross_projection_group_matches_jax(fix, diff):
    """Two SGD-with-momentum steps of a head's parameters under
    ``MULTI_FIX_PROJ`` / ``MULTI_PROJ_TRAIN_DIFF_LR``: the projections
    frozen, or stepped at ``MULTI_PROJ_LR``, the rest at the schedule's
    LR with weight decay, as the JAX optax chain does."""
    rng = np.random.default_rng(21)
    params = {"head": {
        "head_a": {"kernel": rng.standard_normal((6, 3)).astype(np.float32),
                   "bias": rng.standard_normal(3).astype(np.float32)},
        "cross_a_b": {"kernel": rng.standard_normal((3, 2))
                      .astype(np.float32)}}}
    grads = [jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        for _ in range(2)]
    cfgs = []
    for get in (jax_get_cfg, get_cfg):
        cfg = get()
        cfg.SOLVER.OPTIMIZING_METHOD = "sgd"
        cfg.SOLVER.WEIGHT_DECAY = 0.1
        cfg.SOLVER.CLIP_GRAD_L2NORM = None
        cfg.MODEL.MULTI_ADD_CROSS_PROJ = True
        cfg.MODEL.MULTI_FIX_PROJ = fix
        cfg.MODEL.MULTI_PROJ_TRAIN_DIFF_LR = diff
        cfg.MODEL.MULTI_PROJ_LR = 0.03
        cfgs.append(cfg)
    tx, _ = jopt.construct_optimizer(cfgs[0], params, 4)
    p, s = jax.tree_util.tree_map(jnp.asarray, params), None
    s = tx.init(p)
    for g in grads:
        u, s = tx.update(jax.tree_util.tree_map(jnp.asarray, g), s, p)
        p = optax.apply_updates(p, u)
    want = tconvert.jax_tree_to_named(jax.tree_util.tree_map(np.asarray, p))

    head = torch.nn.Module()
    head.head_a = torch.nn.Linear(6, 3)
    head.cross_a_b = torch.nn.Linear(3, 2, bias=False)
    model = torch.nn.Module()
    model.head = head
    model.load_state_dict(tconvert.jax_params_to_state_dict(params))
    opt = topt.construct_optimizer(cfgs[1], model, 4)
    named = dict(model.named_parameters())
    for g in grads:
        for n, v in tconvert.jax_tree_to_named(g).items():
            named[n].grad = torch.from_numpy(v.copy())
        opt.step()
    for n, v in want.items():
        np.testing.assert_allclose(named[n].detach().numpy(), v, rtol=1e-5,
                                   atol=1e-6, err_msg=n)
    moved = not np.allclose(want["head.cross_a_b.weight"],
                            params["head"]["cross_a_b"]["kernel"].T)
    assert moved == (not fix)


def test_cross_projection_warm_start_matches_jax(tmp_path):
    """``.npy`` files of torch-layout ``[dst, src]`` weights (``kinetics``
    named by its class count) into every cross projection, as the JAX
    ``load_cross_proj_weight`` puts them into its tree; a file of another
    shape raises."""
    rng = np.random.default_rng(30)
    names = {"kinetics": "kinetics7", "mmit": "mmit",
             "activitynet": "activitynet"}
    for src, dst in PAIRS:
        w = rng.standard_normal((NCLS[DATASETS.index(dst)],
                                 NCLS[DATASETS.index(src)]))
        np.save(tmp_path / f"{names[src]}_{names[dst]}.npy",
                w.astype(np.float32))
    jcfg, cfg = multihead_cfg(jax_get_cfg), multihead_cfg(get_cfg)
    for c in (jcfg, cfg):
        c.MODEL.LOAD_MULTI_PROJ_INIT_FILE = str(tmp_path)
    model = build_model(cfg, device="cpu")
    params = multihead_params_to_jax(model.state_dict())
    want, n_want = jconvert.load_cross_proj_weight(jcfg, params)
    assert tconvert.load_cross_proj_weight(cfg, model) == n_want == 6
    got = model.state_dict()
    for name, w in tconvert.jax_tree_to_named(want).items():
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)
    np.save(tmp_path / "mmit_activitynet.npy", np.zeros((5, 4), np.float32))
    with pytest.raises(ValueError, match="mmit_activitynet"):
        tconvert.load_cross_proj_weight(cfg, model)
