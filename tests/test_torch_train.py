"""The port's training slice (``models/train.py``) against the JAX
package's on the CPU, same inputs:

* ``build_targets`` array for array (1 and 3 classes);
* ``yolo_loss`` on the same heads and targets: loss at rtol 1e-6, its
  gradient with respect to the heads at rtol 1e-5;
* ``Trainer`` steps from JAX's own init (``init_params(cfg,
  PRNGKey(s))`` carried by ``variables_to_state_dict``): one step (loss
  rtol 1e-5; every params / batch_stats leaf within a relative norm of
  3e-4, the JAX gate of ``tests/test_vision.py:451``; the BatchNorm
  ``running_var`` leaves within 1e-5, which pins flax's biased-variance
  update), five free-running steps (losses rtol 1e-4, leaves 3e-4,
  against JAX's run in one of eight batch orders: see
  ``test_five_steps_match_jax``), and a handover after three JAX steps
  of the variables and optax's Adam ``count`` / ``mu`` / ``nu`` (the
  next two losses at rtol 1e-4, the Adam state at 3e-4);
* the Adam state round trip and the checkpoint file.

No UDP port."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zybo_rt_sampler_image_detection_tpu.models import data as jdata
from zybo_rt_sampler_image_detection_tpu.models import train as jtrain
from zybo_rt_sampler_image_detection_tpu.models import yolo as jyolo
from zybo_rt_sampler_image_detection_torch.models import train, yolo

torch.set_num_threads(2)

LOSS_RTOL = 1e-6          # yolo_loss on the same heads
GRAD_RTOL = 1e-5          # its gradient with respect to the heads
STEP_LOSS_RTOL = 1e-5     # one Trainer step
LEAF_RNORM = 3e-4         # every leaf after a step (tests/test_vision.py:451)
RUNNING_VAR_RNORM = 1e-5  # BatchNorm running_var after one step
CHAIN_LOSS_RTOL = 1e-4    # losses over five steps and after the handover
B = 8                     # the demo batch: the deepest block sees 8*2*2
# the batch orders of test_five_steps_match_jax: as given, then seven
# fixed permutations
ORDERS = [np.arange(B)] + [np.random.default_rng(s).permutation(B)
                           for s in range(7)]


def _cfgs(num_classes=2):
    return (jyolo.YoloConfig(input_size=64, width_mult=0.25,
                             num_classes=num_classes),
            yolo.YoloConfig(input_size=64, width_mult=0.25,
                            num_classes=num_classes))


def _batches(n, num_classes=2, seed=5):
    rng = np.random.default_rng(seed)
    return [jdata.synthetic_detection_batch(rng, B, 64,
                                            num_classes=num_classes)
            for _ in range(n)]


def _random_boxes(rng, n_images, size, num_classes):
    out = []
    for _ in range(n_images):
        k = int(rng.integers(0, 5))
        xy = rng.uniform(0, size - 4, (k, 2))
        wh = rng.uniform(2, size, (k, 2))
        x2y2 = np.minimum(xy + wh, size)
        cls = rng.integers(0, num_classes, (k, 1))
        out.append(np.concatenate([xy, x2y2, cls], 1))
    return out


def _rnorm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _assert_variables_close(got, ref, rnorm=LEAF_RNORM):
    ref_leaves = dict(_leaves(ref))
    got_leaves = dict(_leaves(got))
    assert got_leaves.keys() == ref_leaves.keys()
    for path, r in ref_leaves.items():
        err = _rnorm(got_leaves[path], r)
        assert err < rnorm, (path, err)


def _pair(seed=3, lr=3e-3, num_classes=2):
    """A JAX trainer and a port trainer on the JAX trainer's init."""
    jcfg, cfg = _cfgs(num_classes)
    jtr = jtrain.Trainer(jcfg, learning_rate=lr, seed=seed)
    tr = train.Trainer(cfg, learning_rate=lr, device="cpu")
    tr.state.variables = jtr.state.variables
    return jtr, tr


@pytest.mark.parametrize("num_classes", [1, 3])
def test_build_targets_matches_jax(num_classes):
    jcfg, cfg = _cfgs(num_classes)
    for cfg_pair, size in (((jcfg, cfg), 64),
                           ((jyolo.YoloConfig(num_classes=num_classes),
                             yolo.YoloConfig(num_classes=num_classes)), 416)):
        rng = np.random.default_rng(num_classes)
        boxes = _random_boxes(rng, 6, size, num_classes)
        ref = jtrain.build_targets(cfg_pair[0], boxes)
        got = train.build_targets(cfg_pair[1], boxes)
        assert len(got) == len(ref) == 2
        for (t, m), (rt, rm) in zip(got, ref):
            np.testing.assert_array_equal(t, rt)
            np.testing.assert_array_equal(m, rm)
        assert sum(m.sum() for _, m in got) > 0


@pytest.mark.parametrize("num_classes", [1, 3])
def test_yolo_loss_and_grad_match_jax(num_classes):
    jcfg, cfg = _cfgs(num_classes)
    rng = np.random.default_rng(11)
    n_out = 3 * (5 + num_classes)
    heads = [rng.standard_normal((B, g, g, n_out)).astype(np.float32) * 2
             for g in (2, 4)]
    boxes = _random_boxes(rng, B, 64, num_classes)
    tm = jtrain.build_targets(jcfg, boxes)
    tg = [t for t, _ in tm]
    ms = [m for _, m in tm]

    def jloss(hs):
        return jtrain.yolo_loss(jcfg, hs, [jnp.asarray(t) for t in tg],
                                [jnp.asarray(m) for m in ms])

    ref_loss, ref_grads = jax.value_and_grad(jloss)(
        [jnp.asarray(h) for h in heads])
    th = [torch.tensor(h, requires_grad=True) for h in heads]
    loss = train.yolo_loss(cfg, th, [torch.tensor(t) for t in tg],
                           [torch.tensor(m) for m in ms])
    grads = torch.autograd.grad(loss, th)
    np.testing.assert_allclose(loss.item(), float(ref_loss),
                               rtol=LOSS_RTOL)
    for g, rg in zip(grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(rg),
                                   rtol=GRAD_RTOL, atol=0)


def test_one_step_matches_jax():
    jtr, tr = _pair()
    (images, boxes), = _batches(1)
    ref = jtr.train_step(images, boxes)
    got = tr.train_step(images, boxes)
    np.testing.assert_allclose(got, ref, rtol=STEP_LOSS_RTOL)
    assert tr.state.step == jtr.state.step == 1
    ref_vars = jax.tree.map(np.asarray, jtr.state.variables)
    got_vars = tr.state.variables
    _assert_variables_close(got_vars, ref_vars)
    n = 0
    for block, stats in ref_vars["batch_stats"].items():
        rv = stats["BatchNorm_0"]["var"]
        gv = got_vars["batch_stats"][block]["BatchNorm_0"]["var"]
        err = _rnorm(gv, rv)
        assert err < RUNNING_VAR_RNORM, (block, err)
        n += 1
    assert n == yolo.N_BLOCKS


def _distance(got_losses, got_vars, ref_losses, ref_vars):
    """(max relative loss difference, max leaf relative norm)."""
    ref_leaves = dict(_leaves(ref_vars))
    got_leaves = dict(_leaves(got_vars))
    assert got_leaves.keys() == ref_leaves.keys()
    loss = np.max(np.abs(np.subtract(got_losses, ref_losses))
                  / np.abs(ref_losses))
    return loss, max(_rnorm(got_leaves[p], r) for p, r in ref_leaves.items())


def test_five_steps_match_jax():
    """Five free-running steps of each trainer from JAX's init on the same
    batches.  JAX's FP32 program is order-sensitive here: fed each batch in
    another order (the same training), its step-5 loss moves 1.2e-4 and a
    BatchNorm bias 1e-2 (measured), because a max-pool window of block 0
    whose two largest values differ by 1.1e-6 relative turns its gradients
    of blocks 0-1 by 0.6-1.7%, and Adam carries that on.  So the port is
    held at the gates to JAX's run in the given order or in one of seven
    fixed permutations of every batch (both sides of the near-tie turn up
    among them)."""
    jcfg, cfg = _cfgs()
    batches = _batches(5, seed=6)
    jtr = jtrain.Trainer(jcfg, learning_rate=3e-3, seed=4)
    init = jtr.state.variables
    tr = train.Trainer(cfg, learning_rate=3e-3, device="cpu")
    tr.state.variables = init
    got = [tr.train_step(im, bx) for im, bx in batches]
    distances = []
    for order in ORDERS:
        # a fresh JAX state on the same compiled step
        jtr.state = jtrain.TrainState(
            variables=init, opt_state=jtr.tx.init(init["params"]))
        ref = [jtr.train_step(im[order], [bx[i] for i in order])
               for im, bx in batches]
        distances.append(_distance(got, tr.state.variables, ref,
                                   jax.tree.map(np.asarray,
                                                jtr.state.variables)))
    assert any(loss < CHAIN_LOSS_RTOL and leaf < LEAF_RNORM
               for loss, leaf in distances), distances


def _adam_leaves(opt_state):
    """(count, mu, nu) of the ScaleByAdamState inside optax's chain."""
    adam, = [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return (int(adam.count), jax.tree.map(np.asarray, adam.mu),
            jax.tree.map(np.asarray, adam.nu))


def test_mid_training_handover_matches_jax():
    """Three JAX steps, then the variables and the Adam state carried
    across: the next two losses agree."""
    jcfg, cfg = _cfgs()
    jtr = jtrain.Trainer(jcfg, learning_rate=3e-3, seed=7)
    batches = _batches(5, seed=8)
    for im, bx in batches[:3]:
        jtr.train_step(im, bx)
    tr = train.Trainer(cfg, learning_rate=3e-3, device="cpu")
    tr.state.variables = jtr.state.variables
    count, mu, nu = _adam_leaves(jtr.state.opt_state)
    assert count == 3
    train.optimizer_state_from_numpy(tr.state.model, tr.state.optimizer,
                                     count, mu, nu)
    ref = [jtr.train_step(im, bx) for im, bx in batches[3:]]
    got = [tr.train_step(im, bx) for im, bx in batches[3:]]
    np.testing.assert_allclose(got, ref, rtol=CHAIN_LOSS_RTOL)
    # the carried state moved on as optax's did
    count2, mu2, nu2 = train.optimizer_state_to_numpy(tr.state.model,
                                                      tr.state.optimizer)
    rcount, rmu, rnu = _adam_leaves(jtr.state.opt_state)
    assert count2 == rcount == 5
    _assert_variables_close(mu2, rmu)
    _assert_variables_close(nu2, rnu)


def test_optimizer_state_round_trip():
    _, tr = _pair()
    (images, boxes), = _batches(1)
    tr.train_step(images, boxes)
    count, mu, nu = train.optimizer_state_to_numpy(tr.state.model,
                                                   tr.state.optimizer)
    assert count == 1
    before = {id(p): {k: v.clone() for k, v in st.items()}
              for p, st in tr.state.optimizer.state.items()}
    train.optimizer_state_from_numpy(tr.state.model, tr.state.optimizer,
                                     count, mu, nu)
    for p, st in tr.state.optimizer.state.items():
        for k, v in st.items():
            assert torch.equal(v, before[id(p)][k]), k
    # the JAX layout: conv kernels HWIO, as in the variables
    params = tr.state.variables["params"]
    assert mu.keys() == params.keys()
    for path, leaf in _leaves(params):
        node = mu
        for k in path:
            node = node[k]
        assert node.shape == leaf.shape, path


def test_checkpoint_file_holds_jax_layout(tmp_path):
    """The file holds the variables in the JAX layout, the optimiser's
    state and the step; a restore reproduces all three."""
    _, tr = _pair()
    (images, boxes), = _batches(1)
    tr.train_step(images, boxes)
    p = str(tmp_path / "ckpt.pt")
    train.save_checkpoint(p, tr)
    ck = torch.load(p, weights_only=True)
    assert ck["step"] == 1
    ref = tr.state.variables
    for path, leaf in _leaves(ref):
        node = ck["variables"]
        for k in path:
            node = node[k]
        np.testing.assert_array_equal(node.numpy(), leaf)
    tr2 = train.restore_checkpoint(p, train.Trainer(
        _cfgs()[1], learning_rate=3e-3, device="cpu"))
    _assert_variables_close(tr2.state.variables, ref, rnorm=1e-12)
    c1, m1, _ = train.optimizer_state_to_numpy(tr.state.model,
                                               tr.state.optimizer)
    c2, m2, _ = train.optimizer_state_to_numpy(tr2.state.model,
                                               tr2.state.optimizer)
    assert c1 == c2 == 1
    _assert_variables_close(m2, m1, rnorm=1e-12)


def test_trainer_cuda_default_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        train.Trainer(_cfgs()[1])
