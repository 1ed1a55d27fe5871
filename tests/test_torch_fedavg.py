"""The port's sp FedAvg round against the JAX package's, on the CPU.

Same inputs on both sides: the data (numpy surrogates, bit-identical
shards), the cohorts (``np.random.seed(round_idx)``), the per-epoch index
arrays, and the JAX-initialised parameters carried in through
``models/convert.py``. Tolerances, each from the f32 rounding of two
summation orders and what the training dynamics make of it:

- one local round: the port's update (params - start) within a relative L2
  error of 5e-5 (LR), 2e-5 (ResNet-8 with SGD, FedProx) and 1e-4 (ResNet-8
  with Adam) of JAX's update; mean loss within rtol 1e-5. Measured worst:
  7.3e-6, 2.0e-6 and 1.9e-5. Adam is run on full batches only: with a
  part-masked batch its normalised steps amplify f32 noise, JAX against
  itself with params perturbed by 1e-7 (relative) differs by 0.2-0.8% after
  four to eight steps;
- Parrot config 1 end to end (10 rounds, 12,000 SGD steps): each eval
  round's test_loss within rtol 1e-4 and test_acc within 2 of 2,000 test
  examples, the final params within 1e-4 of their scale;
- the small ResNet federation (2 rounds, 12 steps of lr 0.01): test_loss
  within rtol 1e-4, test_acc within 1, the final params' update within 2e-4
  of JAX's (measured 2.8e-5; JAX against itself with params perturbed by
  1e-7 differs by 1.6e-5 here, and by 5.8e-4 at lr 0.05, where a tolerance
  would measure the dynamics rather than the port).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.core.engine import round_engine as jengine
from fedml_tpu.data import data_loader as jloader
from fedml_tpu.data.dataset import ArrayDataset as JArrayDataset
from fedml_tpu.ml.trainer import local_sgd as jls
from fedml_tpu.models import linear as jlinear
from fedml_tpu.models import resnet as jresnet
from fedml_tpu.models.model_hub import FedModel as JFedModel
from fedml_tpu_torch.core.engine import round_engine as tengine
from fedml_tpu_torch.data import data_loader as tloader
from fedml_tpu_torch.data.dataset import ArrayDataset as TArrayDataset
from fedml_tpu_torch.ml.trainer import local_sgd as tls
from fedml_tpu_torch.ml.trainer.classification_trainer import ClassificationTrainer
from fedml_tpu_torch.models import linear as tlinear
from fedml_tpu_torch.models import resnet as tresnet
from fedml_tpu_torch.models.convert import params_from_jax, params_to_jax
from fedml_tpu_torch.models.model_hub import FedModel as TFedModel
from fedml_tpu_torch.simulation.sp.client import Client

@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tests take thousands of small steps; under several test workers
    a pool of threads in each only spins against the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PARROT = dict(random_seed=0, dataset="mnist", data_cache_dir="", partition_method="hetero",
              partition_alpha=0.5, model="lr", federated_optimizer="FedAvg",
              client_num_in_total=2, client_num_per_round=2, comm_round=10, epochs=1,
              batch_size=10, client_optimizer="sgd", learning_rate=0.03, weight_decay=0.001,
              frequency_of_the_test=5, backend="sp")


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


def _update_rel_err(got, ref, start):
    """||got - ref|| / ||ref - start|| over all leaves (flax layout)."""
    g, r, s = _leaves(got), _leaves(ref), _leaves(start)
    num = sum(float(np.sum((np.asarray(g[k]) - np.asarray(r[k])) ** 2)) for k in r)
    den = sum(float(np.sum((np.asarray(r[k]) - np.asarray(s[k])) ** 2)) for k in r)
    return (num / den) ** 0.5


# --- data, cohorts, index arrays: bit for bit ---------------------------------

def _args(**kw):
    return fedml_tpu_torch.default_config("simulation", **{**PARROT, **kw})


@pytest.mark.parametrize("dataset,method,clients", [
    ("synthetic", "hetero", 5), ("mnist", "hetero", 4), ("mnist", "homo", 3),
    ("cifar10", "hetero", 16), ("cifar10", "homo", 4)])
def test_data_load_shards_are_bit_identical(dataset, method, clients):
    over = dict(dataset=dataset, partition_method=method, client_num_in_total=clients)
    ja, ta = fedml_tpu.default_config("simulation", **{**PARROT, **over}), _args(**over)
    ref, got = jloader.load(ja), tloader.load(ta)
    assert ref[0] == got[0] and ref[1] == got[1] and ref[7] == got[7]
    assert ref[4] == got[4] and ja.output_dim == ta.output_dim
    for r_ds, g_ds in [(ref[2], got[2]), (ref[3], got[3])] + \
            [(ref[5][c], got[5][c]) for c in ref[5]] + [(ref[6][c], got[6][c]) for c in ref[6]]:
        for a, b in ((r_ds.x, g_ds.x), (r_ds.y, g_ds.y)):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_data_load_refuses_what_is_not_ported(tmp_path):
    """Downloads stay refused where no files are found; the LEAF json and
    CIFAR batch files JAX reads, the port reads as JAX does (bit-equal; every
    format in tests/test_torch_data_formats.py). JAX is never asked to
    download: it would probe the network."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tloader.load(_args(dataset="shakespeare", data_cache_dir=str(tmp_path),
                           allow_download=True))
    from tests.test_torch_data_formats import WRITERS

    for dataset in ("shakespeare", "cifar10"):
        WRITERS[dataset](tmp_path)
        over = dict(dataset=dataset, data_cache_dir=str(tmp_path))
        ref = jloader.load(fedml_tpu.default_config("simulation", **{**PARROT, **over}))
        got = tloader.load(_args(**over, allow_download=dataset == "shakespeare"))
        assert got[0] == ref[0] and got[4] == ref[4]
        for c in ref[5]:
            assert np.array_equal(got[5][c].x, ref[5][c].x)


def test_data_load_reads_an_npz_as_jax_does(tmp_path):
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "mnist.npz", x_train=rng.integers(0, 255, (60, 28, 28)),
             y_train=rng.integers(0, 10, 60), x_test=rng.integers(0, 255, (20, 28, 28)),
             y_test=rng.integers(0, 10, 20))
    over = dict(data_cache_dir=str(tmp_path), client_num_in_total=3)
    ref = jloader.load(fedml_tpu.default_config("simulation", **{**PARROT, **over}))
    got = tloader.load(_args(**over))
    assert got[2].x.shape == (60, 28, 28, 1) and np.array_equal(ref[2].x, got[2].x)
    for c in ref[5]:
        assert np.array_equal(ref[5][c].x, got[5][c].x) and np.array_equal(ref[5][c].y, got[5][c].y)


@pytest.mark.parametrize("total,per_round", [(2, 2), (10, 4), (100, 10), (16, 16), (5, 7)])
def test_sample_cohort_is_bit_identical(total, per_round):
    for r in range(6):
        assert tengine.sample_cohort(r, total, per_round) == jengine.sample_cohort(r, total, per_round)
    assert [tengine.eval_due(r, 10, 5) for r in range(10)] == \
        [jengine.eval_due(r, 10, 5) for r in range(10)]


@pytest.mark.parametrize("n,bs,epochs", [(50, 16, 2), (7, 10, 3), (128, 128, 1)])
def test_epoch_index_array_is_bit_identical(n, bs, epochs):
    for a, b in zip(jls.epoch_index_array(n, bs, epochs, 11), tls.epoch_index_array(n, bs, epochs, 11)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# --- the client optimizers, pinned to optax -----------------------------------

@pytest.mark.parametrize("opt", [dict(client_optimizer="sgd", momentum=0.9, weight_decay=5e-4),
                                 dict(client_optimizer="sgd", weight_decay=1e-3),
                                 dict(client_optimizer="sgd"),
                                 dict(client_optimizer="adam", weight_decay=1e-4),
                                 dict(client_optimizer="adam")])
def test_client_optimizer_is_the_optax_chain(opt):
    """torch SGD(momentum, dampening=0, weight_decay) and Adam(eps=1e-8,
    weight_decay) step as optax's add_decayed_weights -> sgd / adam. SGD
    within 1e-6; Adam within 1e-4 of the learning rate over 5 steps: optax
    takes the bias correction 1 - b2^t in f32 of b2 rounded to f32 (1.3e-5
    off at t=1 for b2=0.999), torch in float64, so each update differs by
    up to 6.4e-6 of its size (measured 1.7e-6 = 3.4e-5 lr after 5 steps)."""
    args = type("A", (), dict(learning_rate=0.05, **opt))()
    rng = np.random.default_rng(0)
    p = rng.standard_normal(40).astype(np.float32)
    tx = jls.create_client_optimizer(args)
    jp, st = jnp.asarray(p), None
    st = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p.copy()))
    topt = tls.create_client_optimizer(args, [tp])
    for _ in range(5):
        g = rng.standard_normal(40).astype(np.float32)
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        topt.step()
        atol = 1e-4 * args.learning_rate if args.client_optimizer == "adam" else 1e-6
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=atol)


# --- one local round ----------------------------------------------------------

LOCAL_MODELS = {
    "lr": (lambda: jlinear.LogisticRegression(10), lambda: tlinear.LogisticRegression(784, 10),
           (28, 28, 1)),
    "resnet8": (lambda: jresnet.ResNetCifar(depth=8), lambda: tresnet.ResNetCifar(depth=8),
                (32, 32, 3)),
}
OPTS = {
    "sgd_momentum_wd": dict(client_optimizer="sgd", learning_rate=0.05, momentum=0.9,
                            weight_decay=5e-4),
    "fedprox": dict(client_optimizer="sgd", learning_rate=0.05, weight_decay=1e-3, fedprox_mu=0.1),
    "adam": dict(client_optimizer="adam", learning_rate=1e-3, weight_decay=1e-4),
}
UPDATE_TOL = {("lr", "sgd_momentum_wd"): 5e-5, ("lr", "fedprox"): 5e-5, ("lr", "adam"): 5e-5,
              ("resnet8", "sgd_momentum_wd"): 2e-5, ("resnet8", "fedprox"): 2e-5,
              ("resnet8", "adam"): 1e-4}


@pytest.mark.parametrize("model", list(LOCAL_MODELS))
@pytest.mark.parametrize("opt", list(OPTS))
def test_one_local_round_matches_jax(model, opt):
    make_jax, make_port, shape = LOCAL_MODELS[model]
    # 50 examples in batches of 16 over 2 epochs: 8 steps, every fourth
    # batch 2/16 valid; Adam on ResNet-8 gets 2 full batches (docstring)
    n, epochs = (32, 1) if (model, opt) == ("resnet8", "adam") else (50, 2)
    args = type("A", (), OPTS[opt])()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n,) + shape).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int64)
    jfm = JFedModel(module=make_jax(), params=None, input_shape=(1,) + shape)
    p0 = jax.device_get(jfm.init_params(3))
    idx, mask = tls.epoch_index_array(n, 16, epochs, seed=5)
    ref = jls.make_local_train_fn(jfm, args)(p0, jnp.asarray(x), jnp.asarray(y), jnp.asarray(idx),
                                             jnp.asarray(mask), jax.random.PRNGKey(0), None)
    module = make_port()
    module.load_state_dict(params_from_jax(p0))
    tfm = TFedModel(module=module, params=None, input_shape=(1,) + shape)
    got = tls.make_local_train_fn(tfm, args)(torch.from_numpy(x), torch.from_numpy(y), idx, mask,
                                             torch.Generator().manual_seed(0))
    assert got.num_steps == int(ref.num_steps) == epochs * -(-n // 16)
    err = _update_rel_err(params_to_jax(got.params), jax.device_get(ref.params), p0)
    assert err <= UPDATE_TOL[(model, opt)], err
    np.testing.assert_allclose(float(got.loss), float(ref.loss), rtol=1e-5)


@pytest.mark.parametrize("labels", ["class", "token", "multi_hot"])
def test_masked_loss_and_eval_match_jax(labels):
    """make_loss_fn's three label kinds ([B] and [B, T] integer labels, [B, C]
    multi-hot floats), with masked rows and an all-masked batch (denominator
    max(valid, 1)), and make_eval_fn's sums, against JAX on the same logits."""
    import flax.linen as nn

    class Identity(nn.Module):
        @nn.compact
        def __call__(self, x, train=False):
            return x

    class TorchIdentity(torch.nn.Module):
        def forward(self, x, train=False, rng=None):
            return x

    rng = np.random.default_rng(4)
    shape = {"class": (6, 5), "token": (6, 3, 5), "multi_hot": (6, 5)}[labels]
    logits = rng.standard_normal(shape).astype(np.float32)
    y = (rng.integers(0, 2, shape).astype(np.float32) if labels == "multi_hot"
         else rng.integers(0, 5, shape[:-1]).astype(np.int32))
    jfm = JFedModel(module=Identity(), params={}, input_shape=(1,) + shape[1:])
    tfm = TFedModel(module=TorchIdentity(), params=None, input_shape=(1,) + shape[1:])
    for mask in (np.array([1, 1, 0, 1, 0, 1], np.float32), np.zeros(6, np.float32)):
        ref = jls.make_loss_fn(jfm)({}, jnp.asarray(logits), jnp.asarray(y), jnp.asarray(mask),
                                    jax.random.PRNGKey(0))
        got = tls.masked_loss(torch.from_numpy(logits), torch.from_numpy(y), torch.from_numpy(mask))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6, atol=1e-7)
    ref = jls.make_eval_fn(jfm)({}, jnp.asarray(logits), jnp.asarray(y))
    got = tls.make_eval_fn(tfm)(None, torch.from_numpy(logits), torch.from_numpy(y))
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-6)
    assert float(got[1]) == float(ref[1]) and got[2] == float(ref[2])


def test_grad_transform_hook_sees_state_dicts():
    """The hook gets (grads, params, global_params, extras) as state dicts
    and its output replaces the gradients: zeroing them freezes the model."""
    module = tlinear.LogisticRegression(784, 10)
    fm = TFedModel(module=module, params=None, input_shape=(1, 28, 28, 1))
    start = {k: v.clone() for k, v in module.state_dict().items()}
    seen = []

    def hook(grads, params, global_params, extras):
        seen.append((sorted(grads), sorted(global_params), extras))
        return {k: torch.zeros_like(g) for k, g in grads.items()}

    args = type("A", (), dict(client_optimizer="sgd", learning_rate=0.1))()
    idx, mask = tls.epoch_index_array(20, 8, 1, 0)
    x = torch.randn(20, 28, 28, 1, generator=torch.Generator().manual_seed(0))
    y = torch.randint(0, 10, (20,), generator=torch.Generator().manual_seed(1))
    tls.make_local_train_fn(fm, args, grad_transform=hook)(x, y, idx, mask, None, extras="x")
    assert len(seen) == 3 and seen[0] == (["linear.bias", "linear.weight"],) * 2 + ("x",)
    assert all(torch.equal(start[k], v) for k, v in module.state_dict().items())


# --- the trainer: copies, never aliases ---------------------------------------

def _tiny_trainer():
    args = fedml_tpu_torch.default_config("simulation", batch_size=8, epochs=1,
                                          learning_rate=0.1, weight_decay=0.0, using_gpu=False)
    model = fedml_tpu_torch.model.create(args, 10, device="cpu")
    return args, ClassificationTrainer(model, args)


def test_trainer_copies_params_in_and_out():
    """Two clients of one round, different data: different w_locals, and the
    global they both started from unchanged (torch tensors are mutable)."""
    args, trainer = _tiny_trainer()
    rng = np.random.default_rng(0)
    shards = [TArrayDataset(rng.standard_normal((24, 28, 28, 1)).astype(np.float32),
                            rng.integers(0, 10, 24).astype(np.int64)) for _ in range(2)]
    w_global = trainer.get_model_params()
    frozen = {k: v.clone() for k, v in w_global.items()}
    client = Client(0, shards[0], shards[0], 24, args, "cpu", trainer)
    w_locals = []
    for i in range(2):  # as the engine drives one client slot through a round
        client.update_local_dataset(i, shards[i], shards[i], 24)
        w_locals.append(client.train(w_global))
    assert all(torch.equal(w_global[k], frozen[k]) for k in frozen), "training moved the global"
    assert any(not torch.equal(w_locals[0][k], w_locals[1][k]) for k in frozen)
    assert any(not torch.equal(w_locals[0][k], frozen[k]) for k in frozen)
    # the second client started from the global, not from the first's result
    trainer.set_model_params(w_global)
    trainer._round = 1
    trainer.train(shards[1])
    again = trainer.get_model_params()
    assert all(torch.equal(again[k], w_locals[1][k]) for k in frozen)
    got = trainer.get_model_params()
    got["linear.bias"].add_(1.0)
    assert not torch.equal(trainer.get_model_params()["linear.bias"], got["linear.bias"])


def test_trainer_test_matches_jax_eval():
    args, trainer = _tiny_trainer()
    rng = np.random.default_rng(3)
    data = TArrayDataset(rng.standard_normal((19, 28, 28, 1)).astype(np.float32),
                         rng.integers(0, 10, 19).astype(np.int64))
    jfm = JFedModel(module=jlinear.LogisticRegression(10), input_shape=(1, 28, 28, 1),
                    params=params_to_jax(trainer.model.module))
    from fedml_tpu.ml.aggregator import DefaultServerAggregator as JAgg

    ref = JAgg(jfm, args).test(JArrayDataset(data.x, data.y))
    got = trainer.test(data)
    assert got["test_total"] == ref["test_total"] == 19.0
    assert got["test_correct"] == ref["test_correct"]
    np.testing.assert_allclose(got["test_loss"], ref["test_loss"], rtol=1e-6)


# --- end to end ----------------------------------------------------------------

def _run_jax(args_kw, dataset=None, model_fn=None):
    args = fedml_tpu.init(fedml_tpu.default_config("simulation", **args_kw))
    dataset = dataset or fedml_tpu.data.load(args)[0]
    model = model_fn(args) if model_fn else fedml_tpu.model.create(args, dataset[-1])
    p0 = jax.device_get(model.params)
    runner = fedml_tpu.FedMLRunner(args, "cpu", dataset, model)
    runner.run()
    api = runner.runner.fl_trainer
    return p0, api.metrics_history, jax.device_get(api.model_trainer.get_model_params())


def _run_port(args_kw, p0, dataset=None, module=None):
    args = fedml_tpu_torch.init(fedml_tpu_torch.default_config("simulation", using_gpu=False,
                                                               **args_kw))
    dataset = dataset or fedml_tpu_torch.data.load(args)[0]
    model = fedml_tpu_torch.model.create(args, dataset[-1]) if module is None else TFedModel(
        module=module, params=None, input_shape=(1, 32, 32, 3))
    model.module.load_state_dict(params_from_jax(p0))
    model.params = {k: v.clone() for k, v in model.module.state_dict().items()}
    runner = fedml_tpu_torch.FedMLRunner(args, torch.device("cpu"), dataset, model)
    last = runner.run()
    api = runner.runner.fl_trainer
    return last, api.metrics_history, params_to_jax(api.model_trainer.get_model_params())


def _assert_history_close(got, ref, acc_slack):
    assert [m["round"] for m in got] == [m["round"] for m in ref]
    for g, r in zip(got, ref):
        assert g["test_total"] == r["test_total"]
        np.testing.assert_allclose(g["test_loss"], r["test_loss"], rtol=1e-4)
        assert abs(g["test_correct"] - r["test_correct"]) <= acc_slack, (g, r)


def test_parrot_config_1_tracks_jax_round_by_round():
    """examples/quick_start/parrot/fedml_config.yaml (LR, MNIST surrogate, 2
    clients, 10 rounds, bs 10, lr 0.03, wd 0.001, hetero 0.5) through each
    package's FedMLRunner, from JAX's init params."""
    p0, ref_hist, ref_w = _run_jax(PARROT)
    last, hist, w = _run_port(PARROT, p0)
    assert [m["round"] for m in hist] == [0, 5, 9] and last == hist[-1]
    _assert_history_close(hist, ref_hist, acc_slack=2)
    for k, r in _leaves(ref_w).items():
        g = _leaves(w)[k]
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max(), k


def test_parrot_config_matches_its_yaml():
    import yaml

    with open("examples/quick_start/parrot/fedml_config.yaml") as f:
        cfg = yaml.safe_load(f)
    flat = {k: v for section in cfg.values() for k, v in section.items()}
    for k, v in PARROT.items():
        if k != "data_cache_dir":  # surrogate either way; the tests read nothing outside
            assert flat[k] == v, k


def _small_cifar(load, ds_cls, args):
    """The CIFAR-10 surrogate in 4 hetero shards, each cut to its first 48
    examples, the test set to 256 (a cut of scale, for CPU time)."""
    d = load(args)
    local = {c: ds_cls(s.x[:48], s.y[:48]) for c, s in d[5].items()}
    test = ds_cls(d[3].x[:256], d[3].y[:256])
    return (sum(len(s) for s in local.values()), 256, d[2], test,
            {c: len(s) for c, s in local.items()}, local, {c: test for c in local}, d[7])


@pytest.mark.parametrize("fed_opt", ["FedAvg", "FedOpt"])
def test_small_resnet_federation_tracks_jax(fed_opt):
    """ResNet-8 (width 16) on 4 CIFAR-10 surrogate clients, 2 a round, 2
    rounds, momentum SGD; FedOpt with the server's momentum SGD (its Adam
    and Yogi are held to optax in test_torch_aggregation.py)."""
    kw = dict(PARROT, dataset="cifar10", model="resnet20", client_num_in_total=4,
              client_num_per_round=2, comm_round=2, batch_size=16, learning_rate=0.01,
              momentum=0.9, weight_decay=5e-4, frequency_of_the_test=1,
              federated_optimizer=fed_opt, server_optimizer="sgd", server_lr=1.0,
              server_momentum=0.9)
    jargs = fedml_tpu.default_config("simulation", **kw)
    jdata = _small_cifar(jloader.load, JArrayDataset, jargs)
    tdata = _small_cifar(tloader.load, TArrayDataset,
                         fedml_tpu_torch.default_config("simulation", **kw))

    def jmodel(args):
        m = JFedModel(module=jresnet.ResNetCifar(depth=8), params=None, input_shape=(1, 32, 32, 3))
        m.params = m.init_params(0)
        return m

    p0, ref_hist, ref_w = _run_jax(kw, jdata, jmodel)
    _, hist, w = _run_port(kw, p0, tdata, tresnet.ResNetCifar(depth=8))
    assert [m["round"] for m in hist] == [0, 1]
    _assert_history_close(hist, ref_hist, acc_slack=1)
    assert _update_rel_err(w, ref_w, p0) <= 2e-4


# --- entry points and what is not ported ----------------------------------------

def test_run_simulation_on_the_cpu_and_refusals(tmp_path_factory):
    args = fedml_tpu_torch.default_config("simulation", **{**PARROT, "comm_round": 1,
                                                            "batch_size": 100,
                                                            "using_gpu": False})
    from fedml_tpu_torch.core import telemetry as tel

    since = max((r["seq"] for r in tel.snapshot()["spans"]), default=0)
    out = fedml_tpu_torch.run_simulation(args=args)
    assert out["round"] == 0 and out["test_total"] == 2000.0 and np.isfinite(out["test_loss"])
    names = [r["name"] for r in tel.snapshot()["spans"] if r["seq"] > since]
    for name, n in (("fedavg.round", 1), ("fedavg.sample", 1), ("fedavg.client_train", 2),
                    ("fedavg.aggregate", 1), ("fedavg.eval", 1), ("agg.aggregate", 1)):
        assert names.count(name) == n, (name, names)
    for over, what in [(dict(backend="vmap", async_rounds=True, hierarchy_edges=2),
                        "hierarchy_edges.*HierarchyTree"),
                       (dict(client_execution="threaded"), "threaded"),
                       (dict(allow_download=True), "allow_download")]:
        bad = copy.copy(args)
        for k, v in over.items():
            setattr(bad, k, v)
        with pytest.raises(NotImplementedError, match=what):
            fedml_tpu_torch.run_simulation(backend=bad.backend, args=bad)
    for over in (dict(training_type="cross_device"),):
        bad = copy.copy(args)
        for k, v in over.items():
            setattr(bad, k, v)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fedml_tpu_torch.FedMLRunner(bad, "cpu", None, None)
    # the NCCL and MPI simulators are ported (tests/test_torch_collective_sim.py
    # holds them against JAX): the runner dispatches them as JAX's does
    for backend, simulator in (("NCCL", "SimulatorCollective"), ("MPI", "SimulatorMPI")):
        ok = copy.copy(args)
        ok.backend = backend
        dataset, output_dim = fedml_tpu_torch.data.load(ok)
        model = fedml_tpu_torch.model.create(ok, output_dim, device="cpu")
        runner = fedml_tpu_torch.FedMLRunner(ok, torch.device("cpu"), dataset, model)
        assert type(runner.runner).__name__ == simulator
    with pytest.raises(NotImplementedError, match="using_mlops"):
        fedml_tpu_torch.init(fedml_tpu_torch.default_config("simulation", using_mlops=True))
    # FHE is ported: init configures its facade (the ring products on the
    # CPU when asked for it), and an init without the flag turns it off
    from fedml_tpu_torch.core.fhe.fhe_agg import FedMLFHE

    fedml_tpu_torch.init(fedml_tpu_torch.default_config("simulation", using_gpu=False,
                                                        enable_fhe=True))
    fhe = FedMLFHE.get_instance()
    assert fhe.is_fhe_enabled() and fhe.scheme.ctx.device.type == "cpu"
    fedml_tpu_torch.init(fedml_tpu_torch.default_config("simulation", using_gpu=False))
    assert not fhe.is_fhe_enabled() and fhe.scheme is None
    # the trust middleware is ported: init configures its singletons, and an
    # init without the flags turns them off again
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy
    from fedml_tpu_torch.core.security.fedml_attacker import FedMLAttacker
    from fedml_tpu_torch.core.security.fedml_defender import FedMLDefender

    for flag, facade, what in (("enable_dp", FedMLDifferentialPrivacy, "frame"),
                               ("enable_defense", FedMLDefender, "defender"),
                               ("enable_attack", FedMLAttacker, "attacker")):
        fedml_tpu_torch.init(fedml_tpu_torch.default_config("simulation", **{flag: True}))
        assert facade.get_instance().is_enabled and getattr(facade.get_instance(), what), flag
        fedml_tpu_torch.init(fedml_tpu_torch.default_config("simulation"))
        assert not facade.get_instance().is_enabled, flag
    # the hub builds the LLM names; a JAX orbax dir as pretrained_path stays
    # refused (the port does not load orbax)
    orbax = tmp_path_factory.mktemp("orbax")
    (orbax / "1").mkdir()
    with pytest.raises(ValueError, match="ROADMAP"):
        fedml_tpu_torch.model.create(_args(model="llama", dataset="shakespeare", vocab_size=96,
                                           d_model=32, n_layers=1, n_heads=2, d_ff=64,
                                           seq_len=16, pretrained_path=str(orbax)), 10,
                                     device="cpu")
