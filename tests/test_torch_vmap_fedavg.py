"""The port's client-batched ("vmapped") simulator against the JAX package's,
on the CPU.

Same inputs on both sides: the data (numpy surrogates, bit-identical
shards), the cohorts, the per-client index arrays (``random_seed + k``, k the
cohort position) and the JAX-initialised parameters carried in through
``models/convert.py``. Tolerances:

- ``aggregate_stacked``: within 1e-6 of JAX's and of the float64 weighted
  mean, relative to each leaf's scale (f32 sums of at most 19 terms);
- one client-batched local round, per client: the update within 5e-5 (LR)
  relative L2 of JAX's vmapped round, as ``tests/test_torch_fedavg.py``
  holds the sequential round, Adam within 1e-4 (its bias correction, 6.4e-6
  of an update); ResNet-8 within 1e-10 with both packages in float64, and
  the port's f32 round within 2e-3 of JAX's float64 one (f32 noise on
  random data, measured in the test's docstring);
- ``test_vmap_simulator_learns``'s config end to end (LR, 4 rounds): each
  round's test_loss within rtol 1e-4 and the final params within 1e-4 of
  their scale;
- the ResNet-20 federation with ragged shards (2 rounds, lr 0.01), both
  packages training in float64 (their folds in f32): test_loss within rtol
  1e-7 and the final params' update within 5e-5 of JAX's.

The local-round cases use ResNet-8, the CIFAR ResNet family cut to depth 8
for the CPU's time, as in ``tests/test_torch_fedavg.py``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.core.aggregation import bucketed as jbucketed
from fedml_tpu.data import data_loader as jloader
from fedml_tpu.data.dataset import ArrayDataset as JArrayDataset
from fedml_tpu.ml.trainer import local_sgd as jls
from fedml_tpu.models import linear as jlinear
from fedml_tpu.models import resnet as jresnet
from fedml_tpu.models.model_hub import FedModel as JFedModel
from fedml_tpu.simulation.vmapped.vmap_fedavg import VmapFedAvgAPI as JVmapFedAvgAPI
from fedml_tpu_torch.core.aggregation import bucketed as tbucketed
from fedml_tpu_torch.data import data_loader as tloader
from fedml_tpu_torch.data.dataset import ArrayDataset as TArrayDataset
from fedml_tpu_torch.ml.trainer import local_sgd as tls
from fedml_tpu_torch.models import cnn as tcnn
from fedml_tpu_torch.models import linear as tlinear
from fedml_tpu_torch.models import resnet as tresnet
from fedml_tpu_torch.models.convert import params_from_jax, params_to_jax
from fedml_tpu_torch.models.model_hub import FedModel as TFedModel
from fedml_tpu_torch.simulation.vmapped.vmap_fedavg import VmapFedAvgAPI as TVmapFedAvgAPI


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch steps: under several test workers a pool of threads
    in each only spins against the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_simulators.py::test_vmap_simulator_learns
LEARNS = dict(random_seed=0, backend="vmap", comm_round=4, client_num_in_total=6,
              client_num_per_round=4, epochs=1, batch_size=16, frequency_of_the_test=1,
              dataset="synthetic", data_cache_dir="", model="lr")


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


def _client(tree, k):
    return {name: v[k] for name, v in tree.items()}


# --- the stacked fold ----------------------------------------------------------

@pytest.mark.parametrize("k,bucket", [(5, 4), (19, 16), (3, 16), (16, 16), (7, 1)])
def test_aggregate_stacked_matches_jax_and_the_float64_mean(k, bucket):
    """K not a multiple of the bucket pads with zero rows of weight 0; the
    weights are used as given (not normalised); bf16 leaves fold in f32 and
    are cast back."""
    rng = np.random.default_rng(k)
    shapes = {"a": (3, 4), "b": (7,), "c": (2, 2, 3)}
    leaves = {n: rng.standard_normal((k,) + s).astype(np.float32) for n, s in shapes.items()}
    weights = rng.uniform(0.1, 1.0, k).astype(np.float32)
    stacked = {n: torch.from_numpy(v) for n, v in leaves.items()}
    stacked["c"] = stacked["c"].to(torch.bfloat16)
    got = tbucketed.BucketedAggregator(bucket).aggregate_stacked(stacked, weights)
    jstacked = {n: jnp.asarray(v) for n, v in leaves.items()}
    jstacked["c"] = jstacked["c"].astype(jnp.bfloat16)
    ref = jax.device_get(jbucketed.BucketedAggregator(bucket).aggregate_stacked(
        jstacked, jnp.asarray(weights)))
    for n, s in shapes.items():
        assert got[n].shape == s and got[n].dtype == stacked[n].dtype
        g = got[n].double().numpy()
        want = np.tensordot(weights.astype(np.float64),
                            stacked[n].double().numpy(), axes=(0, 0))
        scale = np.abs(want).max()
        tol = 1e-6 if n != "c" else 2.0 ** -7
        assert np.abs(g - np.asarray(ref[n], np.float64)).max() <= tol * scale, n
        assert np.abs(g - want).max() <= tol * scale, n


def test_stacked_sink_folds_and_refuses_middleware():
    """The stacked sink folds through aggregate_stacked and the aggregator's
    after-hook; with a defense or DP on it unstacks the clients and runs
    the hook pipeline, equal to the hooks applied to the unstacked list."""
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy
    from fedml_tpu_torch.core.engine import RoundResult, StackedBucketedSink
    from fedml_tpu_torch.ml.aggregator import DefaultServerAggregator
    from fedml_tpu_torch.simulation.vmapped.vmap_fedavg import refuse_client_hooks

    args = fedml_tpu_torch.default_config("simulation", using_gpu=False)
    model = fedml_tpu_torch.model.create(args, 10, device="cpu")
    stacked = {k: torch.stack([v, 2 * v, 4 * v]) for k, v in model.params.items()}
    weights = np.asarray([0.5, 0.25, 0.25], np.float32)
    result = RoundResult(stacked=(stacked, weights))
    assert result.k == 3
    out = StackedBucketedSink(DefaultServerAggregator(model, args)).fold(0, None, result)
    for k, v in model.params.items():
        assert torch.allclose(out[k], 2 * v, atol=1e-6)
    args = fedml_tpu_torch.init(fedml_tpu_torch.default_config(
        "simulation", using_gpu=False, enable_dp=True, dp_solution_type="cdp", epsilon=1e3,
        enable_defense=True, defense_type="coordinate_wise_median"))
    try:
        agg = DefaultServerAggregator(model, args)
        got = StackedBucketedSink(agg).fold(0, None, result)
        FedMLDifferentialPrivacy.get_instance().init(args)  # the same draws again
        lst = [(float(weights[i]), {k: v[i] for k, v in stacked.items()}) for i in range(3)]
        want = agg.on_after_aggregation(agg.aggregate(agg.on_before_aggregation(lst)))
        for k, v in model.params.items():
            assert torch.equal(got[k], want[k])
            assert not torch.equal(got[k], 2 * v)  # the median, noised
            assert torch.allclose(got[k], 2 * v, atol=0.1)
        # R7: FHE's encryption is a client hook, which the vmapped front
        # never runs; the port refuses the knob before any round
        args.enable_fhe = True
        with pytest.raises(ValueError, match="enable_fhe.*R7"):
            refuse_client_hooks(args)
    finally:
        fedml_tpu_torch.init(fedml_tpu_torch.default_config("simulation", using_gpu=False))


# --- staging: bit for bit ------------------------------------------------------

def _lr_apis(**over):
    kw = {**LEARNS, **over}
    jargs = fedml_tpu.default_config("simulation", **kw)
    targs = fedml_tpu_torch.default_config("simulation", using_gpu=False, **kw)
    jdata, tdata = jloader.load(jargs), tloader.load(targs)
    jmodel = fedml_tpu.model.create(jargs, jdata[-1])
    tmodel = fedml_tpu_torch.model.create(targs, tdata[-1], device="cpu")
    return (JVmapFedAvgAPI(jargs, "cpu", jdata, jmodel),
            TVmapFedAvgAPI(targs, torch.device("cpu"), tdata, tmodel))


@pytest.mark.parametrize("over,cohort", [
    (dict(), [3, 0, 5, 1]),
    (dict(batch_size=7, epochs=3, random_seed=4), [3, 5]),
    (dict(batch_size=64, epochs=2), [5, 1, 0, 2, 4, 3])])
def test_stack_clients_is_bit_identical(over, cohort):
    """Shards padded to the cohort's largest with zero rows; index and mask
    arrays seeded with random_seed + k (k the cohort position), padded to the
    largest batch count with zero rows: the same arrays as JAX's."""
    japi, tapi = _lr_apis(**over)
    ref = [np.asarray(a) for a in japi._stack_clients(cohort)]
    got = [a.numpy() for a in tapi._stack_clients(cohort)]
    sizes = {len(tapi.train_data_local_dict[c]) for c in cohort}
    assert len(sizes) > 1  # ragged: the padding is exercised
    for name, r, g in zip("x y idx mask".split(), ref, got):
        # JAX runs without 64-bit types: its labels are int32 where the data's are int64
        assert r.dtype == (np.int32 if name == "y" else g.dtype), name
        assert r.shape == g.shape and np.array_equal(r, g), name


# --- one client-batched local round --------------------------------------------

VMAP_MODELS = {
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
# the update's relative L2 error against JAX's round (see the module docstring)
UPDATE_TOL = {("lr", "sgd_momentum_wd"): 5e-5, ("lr", "fedprox"): 5e-5, ("lr", "adam"): 1e-4,
              ("resnet8", "sgd_momentum_wd"): 1e-10, ("resnet8", "fedprox"): 1e-10}
# ResNet-8's f32 round against JAX's float64 round: JAX's own f32 round is
# up to 1.5e-3 from it on this data (measured), the port's up to 6e-4
R8_F32_TOL = 2e-3


def _f64(tree):
    return jax.tree.map(lambda leaf: jnp.asarray(leaf, jnp.float64), tree)


def _ragged_stack(n_per_client, shape, bs, epochs, seed):
    """Clients of different sizes padded as VmapFedAvgAPI._stack_clients pads
    them: the smaller ones get padded steps (all-zero masks)."""
    rng = np.random.default_rng(seed)
    n_max = max(n_per_client)
    x = rng.standard_normal((len(n_per_client), n_max) + shape).astype(np.float32)
    y = rng.integers(0, 10, (len(n_per_client), n_max)).astype(np.int64)
    idxs, masks = [], []
    for k, n in enumerate(n_per_client):
        x[k, n:] = 0.0
        y[k, n:] = 0
        idx, mask = tls.epoch_index_array(n, bs, epochs, seed + k)
        idxs.append(idx)
        masks.append(mask)
    nb = max(i.shape[1] for i in idxs)
    for k in range(len(idxs)):
        pad = nb - idxs[k].shape[1]
        idxs[k] = np.concatenate([idxs[k], np.zeros((epochs, pad, bs), np.int32)], axis=1)
        masks[k] = np.concatenate([masks[k], np.zeros((epochs, pad, bs), np.float32)], axis=1)
    return x, y, np.stack(idxs), np.stack(masks)


@pytest.mark.parametrize("model,opt", [("lr", "sgd_momentum_wd"), ("lr", "fedprox"),
                                       ("lr", "adam"), ("resnet8", "sgd_momentum_wd"),
                                       ("resnet8", "fedprox")])
def test_vmapped_local_round_matches_jax(model, opt):
    """3 clients of 40, 13 and 29 examples in batches of 16 over 2 epochs:
    6, 2 and 4 real steps of 6, so the smaller clients take padded steps,
    where weight decay, momentum (and FedProx's term) still move them, as in
    JAX's jit(vmap(local_train)). LR runs in f32 on both sides. ResNet-8
    runs at lr 0.01 (ResNet training amplifies f32 noise at 0.05) in
    float64 on both sides, and the port's f32 round is held to JAX's float64
    one: on random data the stem's weight gradient (3 input channels) cancels
    heavily, and either package's f32 round lands up to 1.5e-3 (JAX) or 6e-4
    (the port) from the float64 one, a different client each (measured)."""
    make_jax, make_port, shape = VMAP_MODELS[model]
    opts = dict(OPTS[opt], **({"learning_rate": 0.01} if model == "resnet8" else {}))
    args = type("A", (), opts)()
    x, y, idx, mask = _ragged_stack([40, 13, 29], shape, 16, 2, seed=5)
    jfm = JFedModel(module=make_jax(), params=None, input_shape=(1,) + shape)
    p0 = jax.device_get(jfm.init_params(3))
    wide = model == "resnet8"
    with jax.enable_x64(wide):
        jx = jnp.asarray(x, jnp.float64 if wide else jnp.float32)
        vtrain = jax.jit(jax.vmap(jls.make_local_train_fn(jfm, args),
                                  in_axes=(None, 0, 0, 0, 0, 0, None)))
        ref = jax.device_get(vtrain(_f64(p0) if wide else p0, jx, jnp.asarray(y), jnp.asarray(idx),
                                    jnp.asarray(mask), jax.random.split(jax.random.PRNGKey(0), 3),
                                    None))
    for td in ((torch.float64, torch.float32) if wide else (torch.float32,)):
        module = make_port()
        module.load_state_dict(params_from_jax(p0))
        module.to(td)
        tfm = TFedModel(module=module, params=None, input_shape=(1,) + shape)
        w0 = {k: v.detach().clone() for k, v in module.named_parameters()}
        got = tls.make_vmapped_local_train_fn(tfm, args)(
            w0, torch.from_numpy(x).to(td), torch.from_numpy(y), torch.from_numpy(idx),
            torch.from_numpy(mask), 0)
        assert got.num_steps == 6 and all(v.shape[0] == 3 for v in got.params.values())
        assert all(torch.equal(w0[k], v) for k, v in module.named_parameters())  # global unmoved
        tol = UPDATE_TOL[(model, opt)] if td == torch.float64 or not wide else R8_F32_TOL
        for k in range(3):
            ref_k = jax.tree.map(lambda leaf: np.asarray(leaf[k], np.float64), ref.params)
            mine = params_to_jax({n: v.double() for n, v in _client(got.params, k).items()})
            err = _update_rel_err(mine, ref_k, p0)
            assert err <= tol, (td, k, err)
        np.testing.assert_allclose(got.loss.double().numpy(), np.asarray(ref.loss),
                                   rtol=1e-10 if td == torch.float64 else 1e-5)


def test_vmapped_round_equals_the_client_loop():
    """With equal shards (no padded steps) the client-batched round gives
    each client what the sequential local round gives it from the same
    shuffles, within f32 rounding (1e-6 of the update)."""
    args = type("A", (), OPTS["sgd_momentum_wd"])()
    x, y, idx, mask = _ragged_stack([24, 24, 24], (28, 28, 1), 8, 1, seed=9)
    module = tlinear.LogisticRegression(784, 10)
    fm = TFedModel(module=module, params=None, input_shape=(1, 28, 28, 1))
    fm.params = fm.init_params(0)
    w0 = {k: v.clone() for k, v in fm.params.items()}
    got = tls.make_vmapped_local_train_fn(fm, args)(
        w0, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(idx),
        torch.from_numpy(mask), 0)
    seq = tls.make_local_train_fn(fm, args)
    for k in range(3):
        module.load_state_dict(w0)
        ref = seq(torch.from_numpy(x[k]), torch.from_numpy(y[k]), idx[k], mask[k], None)
        for n, v in ref.params.items():
            scale = (v - w0[n]).abs().max()
            assert (got.params[n][k] - v).abs().max() <= 1e-6 * scale + 1e-8, (k, n)
        assert abs(float(got.loss[k]) - float(ref.loss)) <= 1e-6 * float(ref.loss)


def test_seeded_vmapped_round_with_dropout_repeats_bit_for_bit():
    """CNNDropOut's dropout draws, inside the vmap, from the device's default
    generator seeded with the round index for the round: the same round
    repeats bit for bit, another round index draws other masks, two clients
    with the same data draw different masks, and the process's generator is
    left as it was."""
    args = type("A", (), dict(client_optimizer="sgd", learning_rate=0.05))()
    module = tcnn.CNNDropOut()
    fm = TFedModel(module=module, params=None, input_shape=(1, 28, 28, 1))
    fm.params = fm.init_params(0)
    rng = np.random.default_rng(0)
    x1 = rng.standard_normal((12, 28, 28, 1)).astype(np.float32)
    x = torch.from_numpy(np.stack([x1, x1]))
    y = torch.from_numpy(np.stack([rng.integers(0, 10, 12)] * 2))
    idx, mask = tls.epoch_index_array(12, 6, 1, 0)
    idx = torch.from_numpy(np.stack([idx, idx]))
    mask = torch.from_numpy(np.stack([mask, mask]))
    train = tls.make_vmapped_local_train_fn(fm, args)
    state = torch.random.get_rng_state()
    a, b, c = (train(fm.params, x, y, idx, mask, r) for r in (3, 3, 4))
    assert torch.equal(torch.random.get_rng_state(), state)
    for n in a.params:
        assert torch.equal(a.params[n], b.params[n]), n
    assert any(not torch.equal(a.params[n], c.params[n]) for n in a.params)
    assert any(not torch.equal(a.params[n][0], a.params[n][1]) for n in a.params)


# --- end to end ------------------------------------------------------------------

def _run_jax(kw, dataset=None, model_fn=None):
    args = fedml_tpu.init(fedml_tpu.default_config("simulation", **kw))
    dataset = dataset or fedml_tpu.data.load(args)[0]
    model = model_fn(args) if model_fn else fedml_tpu.model.create(args, dataset[-1])
    p0 = jax.device_get(model.params)
    runner = fedml_tpu.FedMLRunner(args, "cpu", dataset, model)
    runner.run()
    api = runner.runner.fl_trainer
    return p0, api.metrics_history, jax.device_get(api.model.params)


def _run_port(kw, p0, dataset=None, module=None, dtype=torch.float32):
    args = fedml_tpu_torch.init(fedml_tpu_torch.default_config("simulation", using_gpu=False, **kw))
    dataset = dataset or fedml_tpu_torch.data.load(args)[0]
    model = fedml_tpu_torch.model.create(args, dataset[-1]) if module is None else TFedModel(
        module=module, params=None, input_shape=(1, 32, 32, 3))
    model.module.load_state_dict(params_from_jax(p0))
    model.module.to(dtype)
    model.params = {k: v.clone() for k, v in model.module.state_dict().items()}
    runner = fedml_tpu_torch.FedMLRunner(args, torch.device("cpu"), dataset, model)
    last = runner.run()
    api = runner.runner.fl_trainer
    assert type(api).__name__ == "VmapFedAvgAPI"
    return last, api.metrics_history, params_to_jax(api.model.params)


def _assert_history_close(got, ref, acc_slack):
    assert [m["round"] for m in got] == [m["round"] for m in ref]
    for g, r in zip(got, ref):
        assert g["test_total"] == r["test_total"]
        np.testing.assert_allclose(g["test_loss"], r["test_loss"], rtol=1e-4)
        assert abs(g["test_correct"] - r["test_correct"]) <= acc_slack, (g, r)


def test_vmap_simulator_tracks_jax_round_by_round():
    """test_vmap_simulator_learns's config (LR, synthetic, 6 clients, 4 a
    round, bs 16, 4 rounds) through each package's FedMLRunner with backend
    vmap, from JAX's init params."""
    p0, ref_hist, ref_w = _run_jax(LEARNS)
    last, hist, w = _run_port(LEARNS, p0)
    assert [m["round"] for m in hist] == [0, 1, 2, 3] and last == hist[-1]
    _assert_history_close(hist, ref_hist, acc_slack=1)
    for k, r in _leaves(ref_w).items():
        g = _leaves(w)[k]
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max(), k


def _ragged_cifar(load, ds_cls, args):
    """The CIFAR-10 surrogate in 4 hetero shards cut to 48, 20, 33 and 40
    examples (batches of 16: 3, 2, 3 and 3 steps, the short client padded
    by one), the test set to 256 (a cut of scale, for CPU time); images in
    float64."""
    d = load(args)
    cut = {0: 48, 1: 20, 2: 33, 3: 40}
    local = {c: ds_cls(s.x[:cut[c]].astype(np.float64), s.y[:cut[c]]) for c, s in d[5].items()}
    test = ds_cls(d[3].x[:256].astype(np.float64), d[3].y[:256])
    return (sum(len(s) for s in local.values()), 256, d[2], test,
            {c: len(s) for c, s in local.items()}, local, {c: test for c in local}, d[7])


def test_resnet20_vmapped_federation_with_ragged_shards_tracks_jax():
    """ResNet-20 on 4 ragged CIFAR-10 surrogate clients, all in every round,
    2 rounds of momentum SGD with weight decay at lr 0.01: the padded steps'
    decay and momentum included. Both packages train in float64, so f32
    noise of the training dynamics (test_vmapped_local_round_matches_jax)
    does not hide a fault; their folds accumulate in f32 in other summation
    orders, which leaves weights an f32 ulp apart after a round: 8.0e-6 of
    the update after 2 rounds and test_loss 1.1e-8 apart (measured; ResNet-8
    gave 7.7e-6 and 3.2e-9). Gates: test_loss within rtol 1e-7, the final
    params' update within 5e-5 of JAX's."""
    kw = dict(LEARNS, dataset="cifar10", model="resnet20", client_num_in_total=4,
              client_num_per_round=4, comm_round=2, partition_method="hetero",
              partition_alpha=0.5, learning_rate=0.01, momentum=0.9, weight_decay=5e-4)
    jdata = _ragged_cifar(jloader.load, JArrayDataset, fedml_tpu.default_config("simulation", **kw))
    tdata = _ragged_cifar(tloader.load, TArrayDataset,
                          fedml_tpu_torch.default_config("simulation", **kw))

    def jmodel(args):
        m = JFedModel(module=jresnet.ResNetCifar(depth=20), params=None, input_shape=(1, 32, 32, 3))
        m.params = _f64(m.init_params(0))
        return m

    with jax.enable_x64(True):
        p0, ref_hist, ref_w = _run_jax(kw, jdata, jmodel)
    _, hist, w = _run_port(kw, p0, tdata, tresnet.ResNetCifar(depth=20), torch.float64)
    assert [m["round"] for m in hist] == [0, 1]
    assert [m["round"] for m in ref_hist] == [0, 1]
    for g, r in zip(hist, ref_hist):
        assert g["test_total"] == r["test_total"] and g["test_correct"] == r["test_correct"]
        np.testing.assert_allclose(g["test_loss"], r["test_loss"], rtol=1e-7)
    assert _update_rel_err(w, ref_w, p0) <= 5e-5


def test_backend_vmap_through_the_entry_points_and_refusals():
    args = fedml_tpu_torch.default_config("simulation", **{**LEARNS, "comm_round": 2,
                                                            "using_gpu": False})
    from fedml_tpu_torch.core import telemetry as tel

    since = max((r["seq"] for r in tel.snapshot()["spans"]), default=0)
    out = fedml_tpu_torch.run_simulation(backend="vmap", args=args)
    assert out["round"] == 1 and np.isfinite(out["test_loss"])
    names = [r["name"] for r in tel.snapshot()["spans"] if r["seq"] > since]
    for name, n in (("fedavg.round", 2), ("fedavg.client_train", 2), ("fedavg.aggregate", 2),
                    ("agg.aggregate_stacked", 2), ("fedavg.eval", 2), ("agg.aggregate", 0)):
        assert names.count(name) == n, (name, names)
    targs = fedml_tpu_torch.init(copy.copy(args))
    data, out_dim = fedml_tpu_torch.data.load(targs)
    model = fedml_tpu_torch.model.create(targs, out_dim, device="cpu")
    runner = fedml_tpu_torch.FedMLRunner(targs, torch.device("cpu"), data, model)
    assert type(runner.runner).__name__ == "SimulatorVmap"
    assert runner.run()["round"] == 1
    bad = copy.copy(args)
    bad.async_rounds = True
    bad.hierarchy_edges = 2
    with pytest.raises(NotImplementedError, match="hierarchy_edges.*simulate_async_rounds"):
        fedml_tpu_torch.run_simulation(backend="vmap", args=bad)
