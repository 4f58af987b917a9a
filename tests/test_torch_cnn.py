"""repro_torch's CNN, quantized packets and LocalTrainer against repro's.

The paper CNN at image size 8 (the fc layer shrinks; all six convs,
BatchNorm and the three pools stay), weights made with numpy and
carried across with `params_from_jax`, batches from the shared
synthetic dataset.  Both packages compute in float32; convolutions sum
in other orders, so forward values agree to ~1e-6 relative and
gradients to ~1e-5 relative of each leaf's largest entry.

The conv biases are special: BatchNorm subtracts each channel's batch
mean right after the bias, so their exact gradient is 0 and both
packages return rounding noise (~1e-8).  They are held to an absolute
1e-6, and after an Adam step to 2·lr: Adam normalises that noise to a
step of ±lr with a random sign.

Two correct float32 trainings drift apart by rounding (~1e-7), and a
ReLU input or a gradient that lies that close to zero then flips: a
ReLU switches in one run and not the other, or Adam turns the gradient
into a step of +lr in one and -lr in the other.  From random conv
biases, the 5th SGD step at lr 0.05 meets a pre-activation of 6e-7 and
the runs part by 5e-4 within 8 steps; Adam's runs part by 8e-4 at the
4th step.  So SGD is held over a whole local loop from `init_cnn`'s
distribution (zero conv biases, where every FL run starts), and Adam
step by step from the reference's own parameters and moments (relative
L2 per leaf, since a few weights with noise-level gradients take ±lr
steps), with the whole loop's mean loss beside it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.core import packets as jpackets
from repro.data.synthetic import batches, make_image_dataset
from repro.federation import LocalTrainer as JLocalTrainer
from repro.models import cnn as jcnn
from repro_torch import optim as topt
from repro_torch.core import packets as tpackets
from repro_torch.federation import LocalTrainer
from repro_torch.models import cnn as tcnn

IMAGE = 8
BATCH = 16
FWD_TOL = dict(rtol=1e-5, atol=1e-5)


def _paths(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _he_init(rng):
    """`init_cnn`'s distribution (He-normal weights, zero biases, unit
    BN), drawn with numpy into the reference's layout."""
    layout = jax.eval_shape(
        lambda: jcnn.init_cnn(jax.random.PRNGKey(0), image_size=IMAGE))
    p = jax.tree_util.tree_map(
        lambda x: np.zeros(x.shape, x.dtype), layout)
    for name, layer in p.items():
        w = layer["w"]
        fan_in = int(np.prod(w.shape[:-1]))
        scale = np.sqrt(2.0 / fan_in) if name != "fc" else 1 / np.sqrt(fan_in)
        layer["w"] = (scale * rng.standard_normal(w.shape)).astype(np.float32)
        for key in ("bn_scale", "bn_var"):
            if key in layer:
                layer[key] = np.ones_like(layer[key])
    return p


@pytest.fixture(scope="module")
def params():
    """The CNN with random BN running statistics and conv biases (so
    eval mode reads real values), as numpy."""
    rng = np.random.default_rng(0)
    p = _he_init(rng)
    for i in range(len(jcnn.CHANNELS)):
        conv = dict(p[f"conv{i}"])
        c = conv["bn_mean"].shape[0]
        conv["bn_mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        conv["bn_var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        conv["b"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        p[f"conv{i}"] = conv
    return p


@pytest.fixture(scope="module")
def init_params():
    return _he_init(np.random.default_rng(1))


@pytest.fixture(scope="module")
def data():
    return make_image_dataset(64, size=IMAGE, noise=1.0, seed=3)


def _port(tree):
    return tpackets.params_from_jax(tree, device="cpu")


@pytest.mark.parametrize("train", [False, True])
def test_apply_cnn_matches(params, data, train):
    x = data.images[:BATCH]
    lj, nj = jcnn.apply_cnn(params, jnp.asarray(x), train=train)
    lt, nt = tcnn.apply_cnn(_port(params), torch.from_numpy(x), train=train)
    assert lt.shape == (BATCH, 10)
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj),
                               **FWD_TOL)
    for path, a, b in zip(_paths(nj), jax.tree_util.tree_leaves(nj),
                          tpackets.tree_flatten(nt)[0], strict=True):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   **FWD_TOL, err_msg=path)


def test_cnn_loss_and_gradient_match(params, data):
    x, y = data.images[:BATCH], data.labels[:BATCH]
    (lj, _), gj = jax.value_and_grad(jcnn.cnn_loss, has_aux=True)(
        params, (jnp.asarray(x), jnp.asarray(y)))
    leaves, treedef = tpackets.tree_flatten(_port(params))
    leaves = [x_.requires_grad_() for x_ in leaves]
    lt, _ = tcnn.cnn_loss(tpackets.tree_unflatten(treedef, leaves),
                          (torch.from_numpy(x), torch.from_numpy(y)))
    gt = torch.autograd.grad(lt, leaves, allow_unused=True)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-6)
    for path, want, got in zip(_paths(gj), jax.tree_util.tree_leaves(gj),
                               gt, strict=True):
        want = np.asarray(want)
        got = np.zeros_like(want) if got is None else got.numpy()
        if path.endswith("['b']") and "conv" in path:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                       err_msg=path)
        else:
            scale = np.abs(want).max()
            assert np.abs(got - want).max() <= 1e-4 * scale, path


def test_cnn_accuracy_and_merge_bn_stats_match(params, data):
    want = jcnn.cnn_accuracy(params, data.images, data.labels, batch=24)
    got = tcnn.cnn_accuracy(_port(params), data.images, data.labels,
                            batch=24)
    assert got == want
    _, nj = jcnn.apply_cnn(params, jnp.asarray(data.images[:8]), train=True)
    _, nt = tcnn.apply_cnn(_port(params), torch.from_numpy(data.images[:8]),
                           train=True)
    merged_j = jcnn.merge_bn_stats(params, nj)
    merged_t = tcnn.merge_bn_stats(_port(params), nt)
    for path, a, b in zip(_paths(merged_j),
                          jax.tree_util.tree_leaves(merged_j),
                          tpackets.tree_flatten(merged_t)[0], strict=True):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   **FWD_TOL, err_msg=path)


def test_float32_products_restores_flags():
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    with tcnn.float32_products():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_pytree_matches(params, bits):
    qj, sj = jpackets.quantize_pytree(params, bits=bits)
    qt, st = tpackets.quantize_pytree(_port(params), bits=bits)
    for a, b in zip(jax.tree_util.tree_leaves(qj),
                    tpackets.tree_flatten(qt)[0], strict=True):
        assert b.dtype == torch.uint8
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert st.zeros == sj.zeros
    np.testing.assert_allclose(st.scales, sj.scales, rtol=1e-7)
    dj = jpackets.dequantize_pytree(qj, sj)
    dt = tpackets.dequantize_pytree(qt, st)
    for a, b in zip(jax.tree_util.tree_leaves(dj),
                    tpackets.tree_flatten(dt)[0], strict=True):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)


def _trainers(name, lr, epochs=2):
    ref = JLocalTrainer(loss_fn=lambda p, b: jcnn.cnn_loss(p, b, train=True),
                        optimizer=getattr(jopt, name)(lr),
                        local_epochs=epochs, state_merge=jcnn.merge_bn_stats)
    port = LocalTrainer(loss_fn=lambda p, b: tcnn.cnn_loss(p, b, train=True),
                        optimizer=getattr(topt, name)(lr),
                        local_epochs=epochs, state_merge=tcnn.merge_bn_stats,
                        device="cpu")
    return ref, port


def _is_conv_bias(path):
    return "conv" in path and path.endswith("['b']")


def test_local_trainer_sgd_matches(init_params, data):
    ref, port = _trainers("sgd", 0.05)
    pj, loss_j = ref.train(init_params,
                           batches(data, BATCH, seed=5, epochs=2))
    pt, loss_t = port.train(_port(init_params),
                            batches(data, BATCH, seed=5, epochs=2))
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-4)
    for path, a, b in zip(_paths(pj), jax.tree_util.tree_leaves(pj),
                          tpackets.tree_flatten(pt)[0], strict=True):
        assert not b.requires_grad
        a, b = np.asarray(a), b.numpy()
        if _is_conv_bias(path):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=path)
        else:
            assert np.abs(b - a).max() <= 1e-4 * np.abs(a).max(), path


def test_local_trainer_adam_steps_match(init_params, data):
    """Every Adam step of the port's trainer, from the reference's
    parameters and moments at that step, lands on the reference's next
    parameters; then the whole loop's mean loss agrees."""
    lr = 1e-3
    ref, port = _trainers("adam", lr)
    params = jax.tree_util.tree_map(jnp.asarray, init_params)
    state = ref.optimizer.init(params)
    for batch in batches(data, BATCH, seed=5, epochs=2):
        got, got_state, got_loss = port.step(
            _port(params),
            topt.OptState(int(state.step), _port(state.slots)),
            (torch.from_numpy(batch[0]), torch.from_numpy(batch[1])))
        params, state, loss = ref._step(params, state, batch)
        assert got_state.step == int(state.step)
        np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
        for path, a, b in zip(_paths(params),
                              jax.tree_util.tree_leaves(params),
                              tpackets.tree_flatten(got)[0], strict=True):
            a, b = np.asarray(a), b.numpy()
            if _is_conv_bias(path):
                np.testing.assert_allclose(b, a, rtol=0, atol=2 * lr,
                                           err_msg=path)
            else:
                assert np.linalg.norm(b - a) <= 1e-4 * np.linalg.norm(a), path
    _, loss_j = ref.train(init_params, batches(data, BATCH, seed=5, epochs=2))
    _, loss_t = port.train(_port(init_params),
                           batches(data, BATCH, seed=5, epochs=2))
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-3)
