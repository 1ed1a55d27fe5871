"""The port's FedNova, SCAFFOLD, FedDyn and Mime (their trainers and server
rules) against the JAX package's, on the CPU.

Each algorithm runs 2 rounds of 3 clients, 2 sampled a round
(``np.random.seed(round_idx)`` cohorts), through each package's
``FedMLRunner`` from JAX's initial params (``models/convert.py``):

- LR on the MNIST surrogate in f32, momentum SGD with weight decay: each
  eval round's test_loss (``LOSS_ATOL``), the final params and the server
  state (SCAFFOLD's ``c``, FedDyn's ``h``, Mime's momentum ``s``) within
  ``LR_TOL`` of their scale;
- ResNet-20 at lr 0.01 on ragged CIFAR-10 surrogate shards, both packages
  training in float64: f32 noise on these data moves either package's
  round by up to 1.5e-3 (``tests/test_torch_vmap_fedavg.py``), which would
  hide a fault. The folds still accumulate in f32 in other summation
  orders, an f32 ulp apart on many weights (``R20_PARAM_TOL``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.core.aggregation import agg_operator as jagg
from fedml_tpu.data import data_loader as jloader
from fedml_tpu.data.dataset import ArrayDataset as JArrayDataset
from fedml_tpu.ml.trainer import fed_trainers as jft
from fedml_tpu.ml.trainer import trainer_creator as jcreator
from fedml_tpu.models import resnet as jresnet
from fedml_tpu.models.model_hub import FedModel as JFedModel
from fedml_tpu_torch.core.aggregation import agg_operator as tagg
from fedml_tpu_torch.data import data_loader as tloader
from fedml_tpu_torch.data.dataset import ArrayDataset as TArrayDataset
from fedml_tpu_torch.ml.trainer import fed_trainers as tft
from fedml_tpu_torch.ml.trainer import trainer_creator as tcreator
from fedml_tpu_torch.models import resnet as tresnet
from fedml_tpu_torch.models.convert import params_from_jax, params_to_jax
from fedml_tpu_torch.models.model_hub import FedModel as TFedModel


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch steps: under several test workers a pool of threads
    in each only spins against the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ALGOS = ["FedNova", "SCAFFOLD", "FedDyn", "Mime"]
STATE = {"SCAFFOLD": "_scaffold_c", "FedDyn": "_feddyn_h", "Mime": "_mime_s"}
BASE = dict(random_seed=0, dataset="mnist", data_cache_dir="", partition_method="hetero",
            partition_alpha=0.5, model="lr", client_num_in_total=3, client_num_per_round=2,
            comm_round=2, epochs=1, batch_size=64, client_optimizer="sgd", learning_rate=0.03,
            momentum=0.9, weight_decay=0.001, frequency_of_the_test=1, backend="sp")
# LR in f32: the final params and the server state against JAX's, relative
# to their scale (measured worst 4.1e-7); test_loss within rtol 1e-4 and an
# absolute 1e-6: the surrogate is fitted to a loss near 2e-4, where f32
# log-softmax rounding (1e-7 an example) is 2e-3 of it (measured, FedDyn)
LR_TOL, LOSS_ATOL = 1e-5, 1e-6
# ResNet-20 in float64: the final params against JAX's relative to the
# largest update, the server state relative to its scale; test_loss within
# rtol 1e-7. Measured worst: params 1.3e-4 (Mime: its folded weights an f32
# ulp apart are 3.9e-5 of the first round's small update, grown by round
# 2; 0 to 4.1e-8 for the others), state 6.1e-8, test_loss 2.5e-8
R20_PARAM_TOL, R20_STATE_TOL = 5e-4, 1e-6


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


def _of_scale(got, ref, start=None):
    """max |got - ref| / max |ref - start| over all leaves (flax layout)."""
    g, r = _leaves(got), _leaves(ref)
    s = _leaves(start) if start is not None else {k: 0.0 for k in r}
    num = max(float(np.abs(np.asarray(g[k], np.float64) - np.asarray(r[k], np.float64)).max())
              for k in r)
    den = max(float(np.abs(np.asarray(r[k], np.float64) - np.asarray(s[k], np.float64)).max())
              for k in r)
    return num / den


def _f64(tree):
    return jax.tree.map(lambda leaf: jnp.asarray(leaf, jnp.float64), tree)


def _run_jax(kw, dataset=None, model_fn=None):
    args = fedml_tpu.init(fedml_tpu.default_config("simulation", **kw))
    dataset = dataset or fedml_tpu.data.load(args)[0]
    model = model_fn(args) if model_fn else fedml_tpu.model.create(args, dataset[-1])
    p0 = jax.device_get(model.params)
    runner = fedml_tpu.FedMLRunner(args, "cpu", dataset, model)
    runner.run()
    api = runner.runner.fl_trainer
    state = getattr(api, STATE[kw["federated_optimizer"]], None) \
        if kw["federated_optimizer"] in STATE else None
    return p0, api.metrics_history, jax.device_get(api.model_trainer.get_model_params()), \
        jax.device_get(state)


def _run_port(kw, p0, dataset=None, module=None, dtype=torch.float32):
    args = fedml_tpu_torch.init(fedml_tpu_torch.default_config("simulation", using_gpu=False, **kw))
    dataset = dataset or fedml_tpu_torch.data.load(args)[0]
    model = fedml_tpu_torch.model.create(args, dataset[-1]) if module is None else TFedModel(
        module=module, params=None, input_shape=(1, 32, 32, 3))
    model.module.load_state_dict(params_from_jax(p0))
    model.module.to(dtype)
    model.params = {k: v.clone() for k, v in model.module.state_dict().items()}
    runner = fedml_tpu_torch.FedMLRunner(args, torch.device("cpu"), dataset, model)
    runner.run()
    api = runner.runner.fl_trainer
    opt = kw["federated_optimizer"]
    state = params_to_jax(getattr(api, STATE[opt])) if opt in STATE else None
    return api.metrics_history, params_to_jax(api.model_trainer.get_model_params()), state


def _ragged_cifar(load, ds_cls, args):
    """The CIFAR-10 surrogate in 3 hetero shards cut to 48, 20 and 33
    examples (batches of 16: 3, 2 and 3 steps, two part-masked), the test
    set to 256 (a cut of scale, for CPU time); images in float64."""
    d = load(args)
    cut = {0: 48, 1: 20, 2: 33}
    local = {c: ds_cls(s.x[:cut[c]].astype(np.float64), s.y[:cut[c]]) for c, s in d[5].items()}
    test = ds_cls(d[3].x[:256].astype(np.float64), d[3].y[:256])
    return (sum(len(s) for s in local.values()), 256, d[2], test,
            {c: len(s) for c, s in local.items()}, local, {c: test for c in local}, d[7])


@pytest.mark.parametrize("opt", ALGOS)
def test_algorithm_tracks_jax_on_lr(opt):
    kw = dict(BASE, federated_optimizer=opt)
    p0, ref_hist, ref_w, ref_state = _run_jax(kw)
    hist, w, state = _run_port(kw, p0)
    assert [m["round"] for m in hist] == [m["round"] for m in ref_hist] == [0, 1]
    for g, r in zip(hist, ref_hist):
        assert g["test_total"] == r["test_total"]
        np.testing.assert_allclose(g["test_loss"], r["test_loss"], rtol=1e-4, atol=LOSS_ATOL)
        assert abs(g["test_correct"] - r["test_correct"]) <= 2, (g, r)
    assert _of_scale(w, ref_w) <= LR_TOL
    if opt in STATE:
        assert _of_scale(state, ref_state) <= LR_TOL, opt


@pytest.mark.parametrize("opt", ALGOS)
def test_algorithm_tracks_jax_on_resnet20_in_float64(opt):
    kw = dict(BASE, federated_optimizer=opt, dataset="cifar10", model="resnet20", batch_size=16,
              learning_rate=0.01, weight_decay=5e-4)
    jdata = _ragged_cifar(jloader.load, JArrayDataset, fedml_tpu.default_config("simulation", **kw))
    tdata = _ragged_cifar(tloader.load, TArrayDataset,
                          fedml_tpu_torch.default_config("simulation", **kw))

    def jmodel(args):
        m = JFedModel(module=jresnet.ResNetCifar(depth=20), params=None,
                      input_shape=(1, 32, 32, 3))
        m.params = _f64(m.init_params(0))
        return m

    with jax.enable_x64(True):
        p0, ref_hist, ref_w, ref_state = _run_jax(kw, jdata, jmodel)
    hist, w, state = _run_port(kw, p0, tdata, tresnet.ResNetCifar(depth=20), torch.float64)
    assert [m["round"] for m in hist] == [m["round"] for m in ref_hist] == [0, 1]
    for g, r in zip(hist, ref_hist):
        assert g["test_total"] == r["test_total"] and g["test_correct"] == r["test_correct"]
        np.testing.assert_allclose(g["test_loss"], r["test_loss"], rtol=1e-7)
    assert _of_scale(w, ref_w, p0) <= R20_PARAM_TOL
    if opt in STATE:
        assert _of_scale(state, ref_state) <= R20_STATE_TOL, opt


# --- the trainers' pieces --------------------------------------------------------

def test_trainer_table_matches_jax():
    """Every optimizer gets the trainer class of the JAX package's table;
    nothing raises any more."""
    for opt in ["FedAvg", "FedOpt", "FedProx"] + ALGOS:
        args = fedml_tpu_torch.default_config("simulation", federated_optimizer=opt,
                                              using_gpu=False)
        model = fedml_tpu_torch.model.create(args, 10, device="cpu")
        jargs = fedml_tpu.default_config("simulation", federated_optimizer=opt)
        jtrainer = jcreator.create_model_trainer(fedml_tpu.model.create(jargs, 10), jargs)
        assert type(tcreator.create_model_trainer(model, args)).__name__ == \
            type(jtrainer).__name__, opt


def test_scaffold_state_is_per_client():
    """tests/test_simulators.py::test_scaffold_state_is_per_client in the
    port: one trainer serves every client, each with its own c_local."""
    args = fedml_tpu_torch.default_config("simulation", federated_optimizer="SCAFFOLD",
                                          using_gpu=False)
    model = fedml_tpu_torch.model.create(args, 10, device="cpu")
    tr = tft.ScaffoldTrainer(model, args)
    tr.set_id(0)
    tr.c_local = {k: torch.ones_like(v) for k, v in tr.c_local.items()}
    c0 = tr.c_local
    tr.set_id(1)
    c1 = tr.c_local
    # client 1 must start from zeros, not client 0's state
    assert all(float(v.abs().sum()) == 0.0 for v in c1.values())
    tr.set_id(0)
    assert tr.c_local is c0


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_fednova_a_i_matches_jax(momentum):
    """a_i from tau (the local steps: 4 batches of 16 over 50 examples, 2
    epochs) and rho (the momentum) as the JAX trainer computes it, exactly;
    d_i = (w_global - w_local) / a_i within 1e-5 of its scale."""
    kw = dict(BASE, federated_optimizer="FedNova", momentum=momentum, batch_size=16, epochs=2)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((50, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, 50).astype(np.int64)
    jargs = fedml_tpu.default_config("simulation", **kw)
    jmodel = fedml_tpu.model.create(jargs, 10)
    jtr = jft.FedNovaTrainer(jmodel, jargs)
    jtr.set_id(1)
    a_ref, d_ref = jtr.train(JArrayDataset(x, y))
    targs = fedml_tpu_torch.default_config("simulation", using_gpu=False, **kw)
    tmodel = fedml_tpu_torch.model.create(targs, 10, device="cpu")
    tmodel.params = params_from_jax(jax.device_get(jmodel.params))
    ttr = tft.FedNovaTrainer(tmodel, targs)
    ttr.set_id(1)
    a_got, d_got = ttr.train(TArrayDataset(x, y))
    tau = 2 * 4
    rho = momentum
    want = tau if rho == 0 else (tau - rho * (1 - rho**tau) / (1 - rho)) / (1 - rho)
    assert a_got == a_ref == want
    assert _of_scale(params_to_jax(d_got), jax.device_get(d_ref)) <= 1e-5


def test_server_rules_match_jax():
    """fednova_aggregate and scaffold_aggregate (and FedMLAggOperator.agg's
    FedNova and SCAFFOLD branches) on the same payloads: f32 folds of 3
    clients, within 1e-6 of each leaf's scale."""
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 3), "b": (5,)}

    def tree():
        return {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}

    def t(tr):
        return {n: torch.from_numpy(v) for n, v in tr.items()}

    def j(tr):
        return {n: jnp.asarray(v) for n, v in tr.items()}

    w, c = tree(), tree()
    counts = [30.0, 12.0, 7.0]
    nova = [(n, (float(a), tree())) for n, a in zip(counts, (8.0, 3.5, 11.25))]
    scaf = [(n, (tree(), tree())) for n in counts]

    def close(got, ref):
        for n in shapes:
            r = np.asarray(ref[n])
            assert np.abs(got[n].numpy() - r).max() <= 1e-6 * np.abs(r).max(), n

    close(tagg.fednova_aggregate(t(w), [(n, (a, t(d))) for n, (a, d) in nova]),
          jagg.fednova_aggregate(j(w), [(n, (a, j(d))) for n, (a, d) in nova]))
    got_w, got_c = tagg.scaffold_aggregate(t(w), t(c), [(n, (t(a), t(b))) for n, (a, b) in scaf],
                                           10, 0.5)
    ref_w, ref_c = jagg.scaffold_aggregate(j(w), j(c), [(n, (j(a), j(b))) for n, (a, b) in scaf],
                                           10, 0.5)
    close(got_w, ref_w)
    close(got_c, ref_c)
    targs = type("A", (), {"federated_optimizer": "FedNova", "fednova_w_global": t(w)})()
    jargs = type("A", (), {"federated_optimizer": "FedNova", "fednova_w_global": j(w)})()
    close(tagg.FedMLAggOperator.agg(targs, [(n, (a, t(d))) for n, (a, d) in nova]),
          jagg.FedMLAggOperator.agg(jargs, [(n, (a, j(d))) for n, (a, d) in nova]))
    targs.federated_optimizer = jargs.federated_optimizer = "SCAFFOLD"
    close(tagg.FedMLAggOperator.agg(targs, [(n, (t(a), t(b))) for n, (a, b) in scaf]),
          jagg.FedMLAggOperator.agg(jargs, [(n, (j(a), j(b))) for n, (a, b) in scaf]))
