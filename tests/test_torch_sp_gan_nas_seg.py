"""The port's FedGAN, FedNAS and FedSeg sp simulators against the JAX
package's, on the CPU, from the same numpy data and JAX's initial
parameters carried across by ``models/convert.py``.

Tolerances:

- FedGAN in float64 on both sides (one Adam with b1 0.5 over the pair):
  JAX draws its latents with ``jax.random``, so the tests compute JAX's z
  (the scan's ``split(PRNGKey(cid + round_idx), 3)`` per step) and inject
  them into the port. The local steps' losses within 1e-10 relative and
  every parameter within 1e-10; two rounds through the runner, the losses
  within 1e-8 relative and the folded params within 1e-6 of each leaf's
  scale (the folds round each client's leaves to float32). In float32 the
  packages part faster: optax's and torch's Adam are one update rounded in
  another order (``simulation/sp/split_nn.py`` states it), a weight whose
  gradient is of f32-noise size moves by a different fraction of lr in
  each, and the GAN's steps amplify it: one client's mean D loss over 5
  steps was measured 3.4e-4 (relative) from JAX's, the first step's 1e-7;
- FedNAS in float64 on both sides (``jax.enable_x64``,
  ``module.to(torch.float64)``): the losses within 1e-10 relative, the
  folded params within 1e-6 of each leaf's scale (both folds round every
  client's leaves to float32, as JAX's ``stacked_weighted_average`` does),
  the genotype and the test accuracy equal;
- FedSeg (float32, SGD): each round's confusion counts equal, the test loss
  within 1e-5 relative, the params' update within 1e-4 (relative L2) of
  JAX's.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.simulation.sp import fedgan as jfedgan
from fedml_tpu.simulation.sp import fedseg as jfedseg
from fedml_tpu.utils.pytree import tree_flatten_to_vector as jax_flatten
from fedml_tpu_torch.models.convert import params_from_jax, params_to_jax, wire_vector
from fedml_tpu_torch.simulation.sp import fedgan as tfedgan
from fedml_tpu_torch.simulation.sp import fedseg as tfedseg

GAN = dict(model="gan", dataset="mnist", federated_optimizer="FedGAN", client_num_in_total=64,
           client_num_per_round=2, partition_method="homo", comm_round=2, epochs=1,
           batch_size=32, learning_rate=2e-4)
NAS = dict(model="darts", dataset="cifar10", federated_optimizer="FedNAS", client_num_in_total=64,
           partition_method="homo", comm_round=1, epochs=1, batch_size=16, learning_rate=0.025,
           darts_width=8, darts_layers=2, darts_steps=2)
SEG = dict(model="unet", dataset="pascal_voc", federated_optimizer="FedSeg", client_num_in_total=4,
           comm_round=2, epochs=1, batch_size=8, learning_rate=0.05)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(**kw):
    """JAX's and the port's (args, dataset, model) on the same data, the
    port's model from JAX's initial parameters."""
    jargs = fedml_tpu.init(fedml_tpu.default_config("simulation", **kw))
    jdata, jdim = fedml_tpu.data.load(jargs)
    jmodel = fedml_tpu.model.create(jargs, jdim)
    targs = fedml_tpu_torch.init(fedml_tpu_torch.default_config("simulation", using_gpu=False,
                                                                **kw))
    tdata, tdim = fedml_tpu_torch.data.load(targs)
    tmodel = fedml_tpu_torch.model.create(targs, tdim, device="cpu")
    tmodel.module.load_state_dict(params_from_jax(jax.device_get(jmodel.params)))
    tmodel.params = {k: v.detach().clone() for k, v in tmodel.module.state_dict().items()}
    return (jargs, jdata, jmodel), (targs, tdata, tmodel)


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


def _assert_adam_close(got, ref, lr, steps):
    g, r = _leaves(got), _leaves(ref)
    assert sorted(g) == sorted(r)
    d = np.concatenate([np.abs(np.asarray(g[k], np.float64) - np.asarray(r[k], np.float64)).ravel()
                        for k in r])
    assert np.median(d) <= 1e-5 and d.max() <= steps * lr, (np.median(d), d.max())


def _update_rel_err(got_state, ref_tree, start_tree):
    start = np.asarray(jax_flatten(start_tree)[0], np.float64)
    ref = np.asarray(jax_flatten(ref_tree)[0], np.float64) - start
    got = wire_vector(got_state, torch.float64).numpy() - start
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


# --- dispatch and the per-pixel gate -----------------------------------------------------

def test_per_pixel_labels_need_fedseg_in_both_packages():
    from fedml_tpu.simulation.simulator import SimulatorSingleProcess as JSim
    from fedml_tpu_torch.simulation.simulator import SimulatorSingleProcess

    (jargs, jdata, jmodel), (targs, tdata, tmodel) = _both(**{**SEG,
                                                              "federated_optimizer": "FedAvg"})
    msg = 'segmentation dataset \\(per-pixel labels\\) requires federated_optimizer: "FedSeg"'
    with pytest.raises(ValueError, match=msg):
        JSim(jargs, "cpu", jdata, jmodel)
    with pytest.raises(ValueError, match=msg):
        SimulatorSingleProcess(targs, torch.device("cpu"), tdata, tmodel)


# --- FedGAN ------------------------------------------------------------------------------

def jax_latents(cid, round_idx, steps, b, latent=64):
    """The z JAX's local scan draws: per step ``rng, zd, zg = split(rng, 3)``
    from ``PRNGKey(cid + round_idx)``; [steps, 2, b, latent]."""
    rng = jax.random.PRNGKey(cid + round_idx)
    out = []
    for _ in range(steps):
        rng, zd, zg = jax.random.split(rng, 3)
        out.append(np.stack([np.asarray(jax.random.normal(zd, (b, latent))),
                             np.asarray(jax.random.normal(zg, (b, latent)))]))
    return np.stack(out)


def _gan_inputs():
    """Both packages' (args, dataset, model) with the pair in float64 (JAX's
    params cast inside ``jax.enable_x64``, which the caller keeps on while
    JAX runs)."""
    (jargs, jdata, jmodel), (targs, tdata, tmodel) = _both(**GAN)
    jmodel.params = jax.tree.map(lambda p: jnp.asarray(p, jnp.float64), jmodel.params)
    tmodel.module.to(torch.float64)
    tmodel.params = {k: v.to(torch.float64) for k, v in tmodel.params.items()}
    return (jargs, jdata, jmodel), (targs, tdata, tmodel)


def _d_step_only(jmodel, x_real, z, lr):
    """The pair after one D update alone (optax, D's gradients), the point
    the G update's frozen-half drift starts from."""
    apply, p0 = jmodel.module.apply, jmodel.params

    def d_loss(p):
        fake = apply({"params": p}, z, method="generate")
        d_real = apply({"params": p}, x_real, method="discriminate")
        d_fake = apply({"params": p}, fake, method="discriminate")
        return (optax.sigmoid_binary_cross_entropy(d_real, jnp.ones_like(d_real)).mean()
                + optax.sigmoid_binary_cross_entropy(d_fake, jnp.zeros_like(d_fake)).mean())

    g = jax.grad(d_loss)(p0)
    g = {"discriminator": g["discriminator"],
         "generator": jax.tree.map(jnp.zeros_like, g["generator"])}
    tx = optax.adam(lr, b1=0.5)
    upd, _ = tx.update(g, tx.init(p0), p0)
    return optax.apply_updates(p0, upd)


def _max_diff(got, ref, keys=None):
    keys = keys or list(ref)
    return max(float(np.abs(np.asarray(got[k], np.float64) - ref[k]).max()) for k in keys)


def test_fedgan_local_steps_match_jax_and_move_the_frozen_half_as_optax():
    lr, steps = GAN["learning_rate"], 3
    with jax.enable_x64(True):
        (jargs, jdata, jmodel), (targs, tdata, tmodel) = _gan_inputs()
        japi = jfedgan.FedGANAPI(jargs, "cpu", jdata, jmodel)
        tapi = tfedgan.FedGANAPI(targs, torch.device("cpu"), tdata, tmodel)
        x = japi.train_local[0].x
        idx = np.asarray(japi._client_batches(0, 0))[:steps]
        z = jax_latents(0, 0, steps, idx.shape[1])
        jp, jdl, jgl = japi._local_train(jmodel.params, jnp.asarray(x), jnp.asarray(idx),
                                         jax.random.PRNGKey(0))
        jp1, _, _ = japi._local_train(jmodel.params, jnp.asarray(x), jnp.asarray(idx[:1]),
                                      jax.random.PRNGKey(0))
        d_only = _leaves(jax.device_get(_d_step_only(jmodel, jnp.asarray(x[idx[0]]),
                                                     jnp.asarray(z[0, 0]), lr)))
        ref, ref1 = _leaves(jax.device_get(jp)), _leaves(jax.device_get(jp1))
    assert z.dtype == np.float64
    xt = torch.from_numpy(x).double()
    tp, tdl, tgl = tapi.local_train(tmodel.params, xt, torch.from_numpy(idx), torch.from_numpy(z))
    np.testing.assert_allclose([float(tdl), float(tgl)], [float(jdl), float(jgl)], rtol=1e-10)
    assert _max_diff(_leaves(params_to_jax(tp)), ref) <= 1e-10

    # one step: the G update moves D by Adam's first moment (zero gradients)
    tp1, _, _ = tapi.local_train(tmodel.params, xt, torch.from_numpy(idx[:1]),
                                 torch.from_numpy(z[:1]))
    d_keys = [k for k in ref1 if k[0] == "discriminator"]
    drift = np.concatenate([np.abs(ref1[k] - d_only[k]).ravel() for k in d_keys])
    assert np.median(drift) > 0.1 * lr, np.median(drift)
    assert _max_diff(_leaves(params_to_jax(tp1)), ref1, d_keys) <= 1e-10


def test_fedgan_rounds_through_the_runner_track_jax(monkeypatch):
    def latents(self, cid, r, steps, b):
        with jax.enable_x64(True):
            return torch.from_numpy(jax_latents(cid, r, steps, b))

    monkeypatch.setattr(tfedgan.FedGANAPI, "_latents", latents)
    with jax.enable_x64(True):
        (jargs, jdata, jmodel), (targs, tdata, tmodel) = _gan_inputs()
        jr = fedml_tpu.FedMLRunner(jargs, "cpu", jdata, jmodel)
        jr.run()
        japi = jr.runner.fl_trainer
        ref = _leaves(jax.device_get(japi.model.params))
    tr = fedml_tpu_torch.FedMLRunner(targs, torch.device("cpu"), tdata, tmodel)
    tr.run()
    tapi = tr.runner.fl_trainer
    assert type(tapi).__name__ == "FedGANAPI"
    assert [m["round"] for m in tapi.metrics_history] == [0, 1]
    for g, r in zip(tapi.metrics_history, japi.metrics_history):
        np.testing.assert_allclose([g["d_loss"], g["g_loss"]], [r["d_loss"], r["g_loss"]],
                                   rtol=1e-8)
    got = _leaves(params_to_jax(tapi.model.params))
    for k in ref:
        assert got[k].dtype == np.float64
        assert np.abs(got[k] - ref[k]).max() <= 1e-6 * max(np.abs(ref[k]).max(), 1e-30), k
    assert tapi.generate(4).shape == (4, 28, 28, 1)


# --- FedNAS ------------------------------------------------------------------------------

def _cut(dataset, n_clients, n_test):
    """The tuple with ``n_clients`` clients and ``n_test`` test examples."""
    d = list(dataset)
    d[3] = d[3].subset(np.arange(n_test))
    d[4] = {c: d[4][c] for c in range(n_clients)}
    d[5] = {c: d[5][c] for c in range(n_clients)}
    return tuple(d)


def test_fednas_round_in_float64_matches_jax_with_the_genotype():
    (jargs, jdata, jmodel), (targs, tdata, tmodel) = _both(**NAS)
    jargs.client_num_in_total = targs.client_num_in_total = 2
    with jax.enable_x64(True):
        jmodel.params = jax.tree.map(lambda p: jnp.asarray(p, jnp.float64), jmodel.params)
        jr = fedml_tpu.FedMLRunner(jargs, "cpu", _cut(jdata, 2, 128), jmodel)
        jr.run()
        japi = jr.runner.fl_trainer
        ref_params = jax.device_get(japi.model.params)
        ref_geno = japi.genotype()
    tmodel.module.to(torch.float64)
    tmodel.params = {k: v.to(torch.float64) for k, v in tmodel.params.items()}
    tr = fedml_tpu_torch.FedMLRunner(targs, torch.device("cpu"), _cut(tdata, 2, 128), tmodel)
    tr.run()
    tapi = tr.runner.fl_trainer
    assert type(tapi).__name__ == "FedNASAPI"
    g, r = tapi.metrics_history[0], japi.metrics_history[0]
    np.testing.assert_allclose([g["weight_loss"], g["arch_loss"]],
                               [r["weight_loss"], r["arch_loss"]], rtol=1e-10)
    assert g["test_acc"] == r["test_acc"] and g["test_total"] == r["test_total"] == 128
    got = _leaves(params_to_jax(tapi.model.params))
    ref = _leaves(ref_params)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == np.float64
        scale = max(np.abs(ref[k]).max(), 1e-30)
        assert np.abs(got[k] - ref[k]).max() <= 1e-6 * scale, k
    assert tapi.genotype() == ref_geno


# --- FedSeg ------------------------------------------------------------------------------

def test_confusion_matrix_and_metrics_match_jax():
    rng = np.random.default_rng(0)
    gt = rng.integers(0, 4, (3, 9, 9)).astype(np.int32)
    gt[0, :2] = 255  # void pixels count nowhere
    pred = rng.integers(0, 4, (3, 9, 9))
    ref = np.asarray(jfedseg._confusion_matrix(jnp.asarray(pred), jnp.asarray(gt), 4))
    got = tfedseg.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(gt), 4).numpy()
    assert np.array_equal(got, ref) and got.sum() == 3 * 81 - 18
    assert tfedseg.segmentation_metrics(torch.from_numpy(got)) == jfedseg.segmentation_metrics(ref)


def test_segmentation_surrogate_is_jax_s():
    jc, jt = jfedseg.make_segmentation_data(3, seed=5)
    tc, tt = tfedseg.make_segmentation_data(3, seed=5)
    for (a, b), (c, d) in zip(list(jc.values()) + [jt], list(tc.values()) + [tt]):
        assert np.array_equal(a, c) and np.array_equal(b, d) and b.dtype == d.dtype


def _jax_cm(japi, params):
    x, y = japi.test_set
    logits = japi.model.apply({"params": params}, jnp.asarray(x))
    return np.asarray(jfedseg._confusion_matrix(jnp.argmax(logits, -1), jnp.asarray(y),
                                                japi.num_classes))


def test_fedseg_rounds_through_the_runner_match_jax():
    (jargs, jdata, jmodel), (targs, tdata, tmodel) = _both(**SEG)
    start = jax.device_get(jmodel.params)
    jr = fedml_tpu.FedMLRunner(jargs, "cpu", jdata, jmodel)
    ref = jr.run()
    tr = fedml_tpu_torch.FedMLRunner(targs, torch.device("cpu"), tdata, tmodel)
    got = tr.run()
    japi, tapi = jr.runner.fl_trainer, tr.runner.fl_trainer
    assert type(tapi).__name__ == "FedSegAPI" and got["round"] == ref["round"] == 1
    assert np.array_equal(tapi.last_confusion.numpy(), _jax_cm(japi, japi.params))
    for key in ("pixel_acc", "pixel_acc_class", "mIoU", "FWIoU"):
        assert got[key] == ref[key], key
    np.testing.assert_allclose(got["test_loss"], ref["test_loss"], rtol=1e-5)
    assert _update_rel_err(tapi.params, jax.device_get(japi.params), start) <= 1e-4


def test_fedseg_standalone_with_a_void_label_matches_jax():
    """The standalone path (its own surrogate and model) with class 2 as the
    void label: masked from the loss and the class weights. The matrix drops
    only labels outside [0, C) (cityscapes' 255), as JAX's one-hot does."""
    args = types.SimpleNamespace(random_seed=3, client_num_in_total=3, comm_round=2, epochs=2,
                                 batch_size=6, learning_rate=0.05, seg_ignore_label=2,
                                 using_gpu=False)
    japi = jfedseg.FedSegAPI(args)
    tapi = tfedseg.FedSegAPI(args)
    start = jax.device_get(japi.params)
    tapi.model.load_state_dict(params_from_jax(start))
    tapi.params = {k: v.detach().clone() for k, v in tapi.model.state_dict().items()}
    ref, got = japi.train(), tapi.train()
    assert np.array_equal(tapi.last_confusion.numpy(), _jax_cm(japi, japi.params))
    for key in ("pixel_acc", "mIoU"):
        assert got[key] == ref[key], key
    np.testing.assert_allclose(got["test_loss"], ref["test_loss"], rtol=1e-5)
    assert _update_rel_err(tapi.params, jax.device_get(japi.params), start) <= 1e-4


# --- run_simulation ----------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(GAN, comm_round=1),
    dict(SEG, comm_round=1),
    dict(NAS, dataset="mnist", client_num_in_total=256, darts_layers=1, darts_steps=1),
], ids=["FedGAN", "FedSeg", "FedNAS"])
def test_run_simulation_runs_each_api_on_the_cpu(kw):
    args = fedml_tpu_torch.default_config("simulation", using_gpu=False, **kw)
    out = fedml_tpu_torch.run_simulation(args=args)
    assert out["round"] == 0
    assert all(np.isfinite(v) for v in out.values())
