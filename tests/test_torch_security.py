"""The port's attacks and defenses (``fedml_tpu_torch/core/security``)
against the JAX package's, on the CPU.

The same numpy-seeded cohorts go into both packages: a flax tree with a Conv
(HWIO) and a Dense ([in, out]) kernel, carried into the port by
``models/convert.py``, so the layouts and the name order differ on the two
sides. Tolerances:

- every deterministic defense, three rounds of it with sampled client ids
  in both packages' Context: the kept set, the Krum and Bulyan selections
  and the 3-sigma flags equal; the weights within rtol 1e-4 (FoolsGold's
  logit amplifies f32 noise in its cosines); the folded and screened
  models within 2e-5 of their scale (f32 sums in other orders; the port
  takes Krum's Gram matrix and FoolsGold's cosines in float64, JAX in f32);
- CClip's buckets and WBC's perturbation: bit-equal (host numpy from JAX's
  seeds, WBC's added in JAX's flat order through ``wire_vector``);
- the zero and flip attacks, label flipping, model replacement, the
  backdoor and the edge-case draws: equal, or within 2e-5 of scale for the
  backdoor's mean and std (ddof 0 on both sides);
- the draws no PRNG can match across frameworks (WeakDP, CRFL, Byzantine
  random, the lazy worker): the std of the draws within 4 standard errors
  (4 / sqrt(2 n)) of their sigma and their mean within 4 sigma / sqrt(n);
- DLG and Inverting Gradients: JAX's own success thresholds on the same
  problem (|corr| of the recovered input above 0.9 and 0.4), and the
  total-variation prior within 1e-6 of JAX's;
- reveal-labels: the same mask;
- Soteria: the sensitivity within rtol 1e-4 (a sum of Jacobian norms over
  |r|, which goes down to 1e-2 here, in f32), the same mask and the masked
  leaves within 1e-6.

Torch is pinned to one thread: the tier-1 command runs the suite under
several xdist workers. Every test leaves both packages' middleware singletons off.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.arguments import default_config as jdefault_config
from fedml_tpu.core.aggregation.agg_operator import FedMLAggOperator as JAgg
from fedml_tpu.core.alg_frame.context import Context as JContext
from fedml_tpu.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy as JDP
from fedml_tpu.core.security import fedml_attacker as jatk_facade
from fedml_tpu.core.security import fedml_defender as jdef_facade
from fedml_tpu.core.security.attack import attacks as jattacks
from fedml_tpu.core.security.attack import gradient_inversion as jgi
from fedml_tpu.core.security.defense import advanced as jadv
from fedml_tpu_torch.core.aggregation.agg_operator import FedMLAggOperator as TAgg
from fedml_tpu_torch.core.alg_frame.context import Context as TContext
from fedml_tpu_torch.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy as TDP
from fedml_tpu_torch.core.security import fedml_attacker as tatk_facade
from fedml_tpu_torch.core.security import fedml_defender as tdef_facade
from fedml_tpu_torch.core.security.attack import attacks as tattacks
from fedml_tpu_torch.core.security.attack import gradient_inversion as tgi
from fedml_tpu_torch.core.security.defense import advanced as tadv
from fedml_tpu_torch.core.security.defense import robust_aggregation as trobust
from fedml_tpu_torch.data.dataset import ArrayDataset as TArrayDataset
from fedml_tpu_torch.models.convert import params_from_jax, params_to_jax

SHAPES = {"Conv_0": {"kernel": (3, 3, 2, 4), "bias": (4,)},
          "Dense_0": {"kernel": (6, 5), "bias": (5,)}}
TREE_TOL = 2e-5
WEIGHT_RTOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reset_middleware():
    """Both packages' attacker, defender and DP singletons off, and the
    round's ids out of both Contexts."""
    off = types.SimpleNamespace()
    for facade in (jatk_facade.FedMLAttacker, jdef_facade.FedMLDefender, JDP,
                   tatk_facade.FedMLAttacker, tdef_facade.FedMLDefender, TDP):
        facade.get_instance().init(off)
    for ctx in (JContext(), TContext()):
        ctx.store.pop("client_indexes_of_round", None)
        ctx.store.pop(ctx.KEY_CLIENT_MODEL_LIST, None)


@pytest.fixture(autouse=True)
def middleware_off():
    reset_middleware()
    yield
    reset_middleware()


def jtree(rng, scale=1.0, shapes=SHAPES):
    return {m: {k: rng.normal(0, scale, s).astype(np.float32) for k, s in leaves.items()}
            for m, leaves in shapes.items()}


def tmap(fn, *trees):
    return {m: {k: fn(*(t[m][k] for t in trees)) for k in trees[0][m]} for m in trees[0]}


def cohort(seed, k=8, outliers=True, flip=True):
    """``k`` numpy flax trees around one base; client 0 scaled 20x and
    client 1 flipped (when ``flip``) when ``outliers``."""
    rng = np.random.default_rng(seed)
    base = jtree(rng)
    out = []
    for i in range(k):
        t = tmap(lambda b: (b + 0.1 * rng.normal(size=b.shape)).astype(np.float32), base)
        if outliers and i == 0:
            t = tmap(lambda v: (20.0 * v).astype(np.float32), t)
        if outliers and flip and i == 1:
            t = tmap(lambda v: -v, t)
        out.append((float(100 + 10 * i), t))
    return out, base


def to_jax(lst):
    return [(n, jax.tree.map(jnp.asarray, t)) for n, t in lst]


def to_port(lst):
    return [(n, params_from_jax(t)) for n, t in lst]


def assert_tree_close(jt, ts, tol=TREE_TOL):
    """A JAX tree and a port state dict agree within ``tol`` of the tree's
    scale, leaf by leaf in the flax layout."""
    got = params_to_jax({k: v.detach() for k, v in ts.items()})
    jl = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jt))
    gl = dict(jax.tree_util.tree_leaves_with_path(got))
    scale = max(float(np.abs(np.asarray(v)).max()) for _, v in jl)
    for path, v in jl:
        np.testing.assert_allclose(np.asarray(gl[path], np.float64), np.asarray(v, np.float64),
                                   rtol=0, atol=tol * max(scale, 1.0), err_msg=str(path))


def assert_list_close(jlst, tlst, tol=TREE_TOL):
    assert len(jlst) == len(tlst)
    for (jn, jt), (tn, tt) in zip(jlst, tlst):
        np.testing.assert_allclose(tn, jn, rtol=WEIGHT_RTOL)
        assert_tree_close(jt, tt, tol)


def cfg(**kw):
    base = dict(random_seed=0, client_num_per_round=8, byzantine_client_num=1,
                federated_optimizer="FedAvg")
    base.update(kw)
    return types.SimpleNamespace(**base)


# per-defense knobs: each makes its mechanism act on the cohort above
DEFENSE_KNOBS = {
    "krum": {}, "multi_krum": {}, "coordinate_wise_median": {},
    "coordinate_wise_trimmed_mean": dict(beta=0.2), "rfa": {}, "geometric_median": {},
    "norm_diff_clipping": dict(norm_bound=2.0), "foolsgold": {}, "3sigma": {},
    "slsgd": dict(alpha=0.1, trim_param_b=1), "bulyan": {}, "cclip": dict(tau=1.0, bucket_size=2),
    "cross_round": dict(cosine_similarity_bound=0.3),
    "outlier_detection": dict(cosine_similarity_bound=0.3), "residual_reweight": {},
    "robust_learning_rate": dict(robust_threshold=4), "soteria": {},
    "wbc": dict(client_idx=0, batch_idx=1), "3sigma_foolsgold": {}, "3sigma_geomedian": {},
}
NOISY_DEFENSES = ("weak_dp", "crfl")
# FoolsGold pardons by the ratio of each client's largest cosine to the
# others': a client no other resembles has the (zero) diagonal as its
# largest, and JAX's f32 rounding of that zero decides its weight. These
# cohorts keep every client's largest cosine near 1.
FOOLSGOLD = ("foolsgold", "3sigma_foolsgold")


def _defenders(name, **kw):
    args_j = cfg(enable_defense=True, defense_type=name, **DEFENSE_KNOBS.get(name, {}), **kw)
    args_t = cfg(enable_defense=True, defense_type=name, **DEFENSE_KNOBS.get(name, {}), **kw)
    jd, td = jdef_facade.FedMLDefender.get_instance(), tdef_facade.FedMLDefender.get_instance()
    jd.init(args_j)
    td.init(args_t)
    return jd, td, args_j, args_t


def test_defense_table_is_jax_table():
    jd, td = jdef_facade.FedMLDefender.get_instance(), tdef_facade.FedMLDefender.get_instance()
    names = sorted(set(DEFENSE_KNOBS) | set(NOISY_DEFENSES))
    assert len(names) == 22
    for name in names:
        jd.init(cfg(enable_defense=True, defense_type=name))
        td.init(cfg(enable_defense=True, defense_type=name))
        assert type(jd.defender).__name__ == type(td.defender).__name__, name
    with pytest.raises(ValueError, match="unknown defense"):
        td.init(cfg(enable_defense=True, defense_type="bogus"))
    args = cfg(enable_defense=True, defense_type="multi_krum", client_num_per_round=16)
    td.init(args)
    assert args.krum_param_m == 8 and td.defender.multi == 8


@pytest.mark.parametrize("name", sorted(DEFENSE_KNOBS))
def test_defense_matches_jax_over_three_rounds(name):
    """The three hooks of each deterministic defense, three rounds with
    sampled ids, against JAX's on the same cohorts."""
    jd, td, args_j, args_t = _defenders(name)
    rng = np.random.default_rng(7)
    for r in range(3):
        lst, base = cohort(seed=10 + r, flip=name not in FOOLSGOLD)
        ids = sorted(int(i) for i in rng.choice(12, 8, replace=False))
        JContext().add("client_indexes_of_round", ids)
        TContext().add("client_indexes_of_round", ids)
        jg, tg = jax.tree.map(jnp.asarray, base), params_from_jax(base)
        jl = jd.defend_before_aggregation(to_jax(lst), jg)
        tl = td.defend_before_aggregation(to_port(lst), tg)
        assert_list_close(jl, tl)
        jagg = jd.defend_on_aggregation(jl, JAgg.agg, jg)
        tagg = td.defend_on_aggregation(tl, TAgg.agg, tg)
        assert_tree_close(jagg, tagg)
        assert_tree_close(jd.defend_after_aggregation(jagg), td.defend_after_aggregation(tagg))
        jdef, tdef = jd.defender, td.defender
        if name in ("cross_round", "outlier_detection"):
            jc = getattr(jdef, "cross_round_check", jdef)
            tc = getattr(tdef, "cross_round_check", tdef)
            assert tc.potentially_poisoned_worker_list == jc.potentially_poisoned_worker_list
            assert tc.lazy_worker_list == jc.lazy_worker_list
            assert sorted(tc.client_cache) == sorted(jc.client_cache)
            for cid, feat in jc.client_cache.items():
                np.testing.assert_array_equal(tc.client_cache[cid], feat)
        if name in ("3sigma", "outlier_detection"):
            assert tdef.get_malicious_client_idxs() == jdef.get_malicious_client_idxs()
        if name == "cclip":
            assert tdef.buckets  # the permutation is JAX's: the lists above match
        if name == "foolsgold":
            assert sorted(tdef.memory) == sorted(int(c) for c in jdef.memory)


def test_krum_and_bulyan_keep_no_attacker():
    """multi-Krum and Bulyan on a 16-client cohort whose first 4 are
    Byzantine random: the same selection and fold as JAX's, no attacker
    kept."""
    lst, base = cohort(seed=3, k=16, outliers=False)
    rng = np.random.default_rng(5)
    for i in range(4):
        lst[i] = (lst[i][0], tmap(lambda b: rng.normal(size=b.shape).astype(np.float32), base))
    over = dict(client_num_per_round=16, byzantine_client_num=4)
    jd, td, _, _ = _defenders("multi_krum", **over)
    jl = jd.defend_before_aggregation(to_jax(lst))
    tl = td.defend_before_aggregation(to_port(lst))
    assert_list_close(jl, tl)
    assert len(td.defender.selected) == 8 and min(td.defender.selected) >= 4
    # Bulyan needs n >= 4f + 3: at 16 clients it tolerates f = 3, and picks
    # theta = n - 2f = 10
    jd, td, _, _ = _defenders("bulyan", **dict(over, byzantine_client_num=3))
    assert_tree_close(jd.defend_on_aggregation(to_jax(lst), JAgg.agg),
                      td.defend_on_aggregation(to_port(lst), TAgg.agg))
    assert len(td.defender.selected) == 10 and min(td.defender.selected) >= 4


def test_even_median_and_stable_ties_follow_jax():
    """jnp.median averages the two middle values of an even count and
    jnp.argsort keeps ties in order; the port's median0 and Krum do too."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 33)).astype(np.float32)
    np.testing.assert_allclose(trobust.median0(torch.from_numpy(x)).numpy(),
                               np.asarray(jnp.median(jnp.asarray(x), axis=0)), rtol=0, atol=1e-7)
    x[:, :3] = np.round(x[:, :3])  # ties along the client axis
    np.testing.assert_allclose(trobust.median0(torch.from_numpy(x)).numpy(),
                               np.asarray(jnp.median(jnp.asarray(x), axis=0)), rtol=0, atol=1e-7)
    same = np.tile(rng.normal(size=(1, 9)).astype(np.float32), (6, 1))
    sel = trobust.krum_select(torch.from_numpy(same), 1, 4)
    assert sel.tolist() == [0, 1, 2, 3]
    from fedml_tpu.core.security.defense.robust_aggregation import krum_select as jkrum
    assert np.asarray(jkrum(jnp.asarray(same), 1, 4)).tolist() == [0, 1, 2, 3]
    sel3 = trobust.krum_select(torch.from_numpy(x[:7]), 1, 3).tolist()
    assert sel3 == np.asarray(jkrum(jnp.asarray(x[:7]), 1, 3)).tolist()


def test_defenses_fold_float64_like_float32():
    """The defense functions keep float64 inputs in float64 (the card's
    folds are held to a float64 CPU run), and agree with their f32 fold."""
    lst, base = cohort(seed=4)
    t32 = to_port(lst)
    t64 = [(n, {k: v.double() for k, v in t.items()}) for n, t in t32]
    for name in ("coordinate_wise_median", "rfa", "bulyan", "residual_reweight"):
        _, td, _, _ = _defenders(name)
        a = td.defend_on_aggregation(t32, TAgg.agg)
        b = td.defend_on_aggregation(t64, TAgg.agg)
        for k in a:
            assert b[k].dtype == torch.float64
            assert float((a[k].double() - b[k]).abs().max()) <= 1e-5 * max(
                1.0, float(b[k].abs().max())), (name, k)


@pytest.mark.parametrize("name", NOISY_DEFENSES)
def test_noisy_defenses_draw_their_sigma(name):
    """WeakDP noises each client, CRFL the clipped global model: the draws'
    statistics against the configured sigma (no PRNG matches JAX's)."""
    shapes = {"Dense_0": {"kernel": (200, 50), "bias": (50,)}}
    rng = np.random.default_rng(1)
    trees = [jtree(rng, shapes=shapes) for _ in range(4)]
    over = dict(stddev=0.01) if name == "weak_dp" else dict(clip_threshold=1e9, crfl_sigma=0.02)
    sigma = 0.01 if name == "weak_dp" else 0.02
    jd, td, _, _ = _defenders(name, **over)
    tl = [(1.0, params_from_jax(t)) for t in trees]
    if name == "weak_dp":
        out = td.defend_before_aggregation(tl)
        jout = jd.defend_before_aggregation(to_jax([(1.0, t) for t in trees]))
        diffs = [torch.cat([(o[k] - i[k]).reshape(-1) for k in i]) for (_, o), (_, i) in zip(out, tl)]
        jdiffs = [np.concatenate([np.ravel(np.asarray(o[m][k]) - t[m][k]) for m in t for k in t[m]])
                  for (_, o), t in zip(jout, trees)]
    else:
        g = tl[0][1]
        out = td.defend_after_aggregation(g)
        diffs = [torch.cat([(out[k] - g[k]).reshape(-1) for k in g])]
        jo = jd.defend_after_aggregation(jax.tree.map(jnp.asarray, trees[0]))
        jdiffs = [np.concatenate([np.ravel(np.asarray(jo[m][k]) - trees[0][m][k])
                                  for m in trees[0] for k in trees[0][m]])]
    d = torch.cat(diffs).double().numpy()
    n = d.size
    for sample in (d, np.concatenate(jdiffs).astype(np.float64)):
        assert abs(sample.std() / sigma - 1) <= 4 / np.sqrt(2 * n)
        assert abs(sample.mean()) <= 4 * sigma / np.sqrt(n)


def test_cclip_buckets_and_wbc_perturbation_are_bit_equal():
    lst, base = cohort(seed=6)
    jd = jadv.CClipDefense(cfg(tau=1.0, bucket_size=3))
    td = tadv.CClipDefense(cfg(tau=1.0, bucket_size=3))
    jb = jd._bucketize(to_jax(lst))
    tb = td._bucketize(to_port(lst))
    assert_list_close(jb, tb, tol=1e-7)
    assert [len(b) for b in td.buckets] == [3, 3, 2]
    for batch_idx in (0, 1):
        jw = jadv.WbcDefense(cfg(client_idx=2, batch_idx=batch_idx))
        tw = tadv.WbcDefense(cfg(client_idx=2, batch_idx=batch_idx))
        for r in range(2):
            lst, _ = cohort(seed=20 + r)
            ja = jw.defend_on_aggregation(to_jax(lst), lambda c, l: l[2][1])
            ta = tw.defend_on_aggregation(to_port(lst), lambda c, l: l[2][1])
            got = params_to_jax(ta)
            for m in got:
                for k in got[m]:
                    np.testing.assert_array_equal(got[m][k], np.asarray(ja[m][k]))
        np.testing.assert_array_equal(tw.old_gradient["flat"], jw.old_gradient["flat"])


def test_soteria_masks_the_flax_path_like_jax():
    """Soteria over a Dense representation: the sensitivity, the percentile
    mask and the masked kernel (flax [in, out] against torch [out, in])."""
    rng = np.random.default_rng(2)
    shapes = {"Dense_0": {"kernel": (12, 16), "bias": (16,)},
              "Dense_1": {"kernel": (16, 3), "bias": (3,)}}
    data = rng.normal(size=(5, 12)).astype(np.float32)

    def jrepr(p, x):
        return jnp.tanh(x @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"])

    def trepr(p, x):
        return torch.tanh(x @ p["Dense_0.weight"].T + p["Dense_0.bias"])

    c = cfg(soteria_percentile=25.0, defense_data=data)
    jd = jadv.SoteriaDefense(c, repr_fn=jrepr, repr_param_path="Dense_0")
    td = tadv.SoteriaDefense(c, repr_fn=trepr, repr_param_path="Dense_0")
    trees = [jtree(rng, shapes=shapes) for _ in range(2)]
    jl = jd.defend_before_aggregation(to_jax([(1.0, t) for t in trees]))
    tl = td.defend_before_aggregation(to_port([(1.0, t) for t in trees]))
    js = np.asarray(jd._sensitivity(jax.tree.map(jnp.asarray, trees[0]), jnp.asarray(data)))
    ts = td.sensitivity(params_from_jax(trees[0]), torch.from_numpy(data)).numpy()
    np.testing.assert_allclose(ts, js, rtol=1e-4)
    assert_list_close(jl, tl, tol=1e-6)
    zeroed = (params_to_jax(tl[0][1])["Dense_0"]["kernel"] == 0).all(axis=0)
    assert zeroed.sum() == 4  # the 25th percentile of 16 sensitivities
    assert not (params_to_jax(tl[0][1])["Dense_1"]["kernel"] == 0).any()


def test_async_front_disables_cohort_defenses(caplog):
    """The legacy async front runs each arrival through the hooks with the
    defender off (one warning), the attack still on."""
    from fedml_tpu_torch.simulation.sp.async_fedavg import AsyncFedAvgAPI

    AsyncFedAvgAPI._warned_agg_defense = False
    args = fedml_tpu_torch.default_config(
        "simulation", model="lr", dataset="mnist", comm_round=2, epochs=1,
        client_num_in_total=3, client_num_per_round=2, federated_optimizer="Async_FedAvg",
        enable_defense=True, defense_type="multi_krum", enable_attack=True,
        attack_type="byzantine", attack_mode="zero", using_gpu=False, frequency_of_the_test=1)
    with caplog.at_level("WARNING"):
        out = fedml_tpu_torch.run_simulation(args=args)
    assert np.isfinite(out["test_loss"])
    assert sum("DISABLED" in r.getMessage() for r in caplog.records) == 1
    assert tdef_facade.FedMLDefender.get_instance().is_enabled


# --- attacks ----------------------------------------------------------------

ATTACKS = ("byzantine", "label_flipping", "model_replacement", "lazy_worker", "dlg",
           "invert_gradient", "backdoor", "edge_case_backdoor", "revealing_labels")


def test_attack_dispatch_is_jax_dispatch():
    ja, ta = jatk_facade.FedMLAttacker.get_instance(), tatk_facade.FedMLAttacker.get_instance()
    for name in ATTACKS:
        ja.init(cfg(enable_attack=True, attack_type=name))
        ta.init(cfg(enable_attack=True, attack_type=name))
        assert type(ja.attacker).__name__ == type(ta.attacker).__name__, name
        for pred in ("is_model_attack", "is_data_poisoning_attack", "is_reconstruct_data_attack"):
            assert getattr(ta, pred)() == getattr(ja, pred)(), (name, pred)
    with pytest.raises(ValueError, match="unknown attack"):
        ta.init(cfg(enable_attack=True, attack_type="bogus"))


@pytest.mark.parametrize("mode", ["zero", "flip", "random"])
def test_byzantine_attack(mode):
    lst, base = cohort(seed=8, outliers=False)
    c = cfg(byzantine_client_num=3, attack_mode=mode)
    jo = jattacks.ByzantineAttack(c).attack_model(to_jax(lst))
    to = tattacks.ByzantineAttack(c).attack_model(to_port(lst))
    assert_list_close(jo[3:], to[3:], tol=0.0)
    if mode != "random":
        assert_list_close(jo, to, tol=0.0)
        return
    d = torch.cat([v.reshape(-1) for _, t in to[:3] for v in t.values()]).double().numpy()
    assert abs(d.std() - 1) <= 4 / np.sqrt(2 * d.size) and abs(d.mean()) <= 4 / np.sqrt(d.size)
    first, second = (torch.cat([v.reshape(-1) for v in to[i][1].values()]) for i in (0, 1))
    assert not torch.equal(first, second)  # each attacker draws anew


def test_label_flipping_on_pairs_and_datasets():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 4)).astype(np.float32)
    y = rng.integers(0, 10, 50)
    c = cfg(original_class_list=[3], target_class_list=[9])
    jx, jy = jattacks.LabelFlippingAttack(c).poison_data((x, y))
    tx, ty = tattacks.LabelFlippingAttack(c).poison_data((x, y))
    np.testing.assert_array_equal(ty, jy)
    out = tattacks.LabelFlippingAttack(c).poison_data(TArrayDataset(x, y))
    assert isinstance(out, TArrayDataset)
    np.testing.assert_array_equal(out.y, jy)
    assert (y == 3).any() and not (out.y == 3).any()


def test_model_replacement_and_backdoor():
    lst, base = cohort(seed=9, k=6, outliers=False)
    jg = jax.tree.map(jnp.asarray, base)
    for scale in (0.0, 3.0):
        c = cfg(attack_scale=scale)
        assert_list_close(
            jattacks.ModelReplacementBackdoorAttack(c).attack_model(to_jax(lst), jg),
            tattacks.ModelReplacementBackdoorAttack(c).attack_model(to_port(lst),
                                                                    params_from_jax(base)))
    c = cfg(backdoor_client_num=2, num_std=1.5)
    assert_list_close(jattacks.BackdoorAttack(c).attack_model(to_jax(lst)),
                      tattacks.BackdoorAttack(c).attack_model(to_port(lst)))


@pytest.mark.parametrize("pool", [False, True])
def test_edge_case_backdoor_draws_are_jax_draws(pool):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(60, 4)).astype(np.float32)
    y = rng.integers(0, 10, 60)
    bx = np.full((10, 4), 9.0, np.float32) + np.arange(10, dtype=np.float32)[:, None]
    c = cfg(backdoor_sample_percentage=0.2, target_class=5, data_cache_dir="")
    ja = jattacks.EdgeCaseBackdoorAttack(c, backdoor_dataset=(bx, None) if pool else None)
    ta = tattacks.EdgeCaseBackdoorAttack(c, backdoor_dataset=(bx, None) if pool else None)
    for _ in range(2):
        jx, jy = ja.poison_data((x, y))
        tout = ta.poison_data(TArrayDataset(x, y))
        np.testing.assert_array_equal(tout.x, jx)
        np.testing.assert_array_equal(tout.y, jy)
    with pytest.raises(ValueError, match="does not match local data"):
        tattacks.EdgeCaseBackdoorAttack(c, backdoor_dataset=(np.zeros((3, 7)), None)).poison_data(
            (x, y))


def test_edge_case_loader_matches_jax(tmp_path):
    from fedml_tpu.data import sources as jsources
    from fedml_tpu_torch.data import sources as tsources

    assert tsources.edge_case_pickle_path(str(tmp_path)) == jsources.edge_case_pickle_path(
        str(tmp_path))
    for a, b in zip(tsources.load_edge_case_examples(seed=3, n=16, target_class=2),
                    jsources.load_edge_case_examples(seed=3, n=16, target_class=2)):
        np.testing.assert_array_equal(a, b)


def test_lazy_worker_resubmits_a_noisy_global():
    lst, base = cohort(seed=11, outliers=False)
    c = cfg(lazy_worker_num=2, lazy_noise=1e-2)
    g = params_from_jax(base)
    out = tattacks.LazyWorkerAttack(c).attack_model(to_port(lst), g)
    jout = jattacks.LazyWorkerAttack(c).attack_model(to_jax(lst), jax.tree.map(jnp.asarray, base))
    assert_list_close(jout[2:], out[2:], tol=0.0)
    for sample in ([out[i][1][k] - g[k] for i in range(2) for k in g],
                   [torch.from_numpy(np.asarray(jout[i][1][m][k]) - base[m][k])
                    for i in range(2) for m in base for k in base[m]]):
        d = torch.cat([s.reshape(-1) for s in sample]).double().numpy()
        assert abs(d.std() / 1e-2 - 1) <= 4 / np.sqrt(2 * d.size)
        assert abs(d.mean()) <= 4 * 1e-2 / np.sqrt(d.size)


def _lr_problem(x_shape, num_classes, seed):
    """JAX's DLG test problem (tests/test_gradient_inversion.py) on both sides."""
    rng = np.random.default_rng(seed)
    d = int(np.prod(x_shape[1:]))
    w = rng.normal(0, 0.3, (d, num_classes)).astype(np.float32)
    x_true = rng.normal(size=x_shape).astype(np.float32)
    y_true = rng.integers(0, num_classes, x_shape[0])

    def jgrad(params, x, y_soft):
        def loss(p):
            logp = jax.nn.log_softmax(x.reshape(x.shape[0], -1) @ p)
            return -jnp.mean(jnp.sum(y_soft * logp, axis=-1))
        return jax.grad(loss)(params)

    def tgrad(params, x, y_soft):
        logp = torch.log_softmax(x.reshape(x.shape[0], -1) @ params, dim=-1)
        loss = -(y_soft * logp).sum(dim=-1).mean()
        return torch.autograd.grad(loss, [params], create_graph=True)

    tw = torch.from_numpy(w).requires_grad_()
    observed = [g.detach() for g in tgrad(tw, torch.from_numpy(x_true),
                                          torch.nn.functional.one_hot(torch.from_numpy(y_true),
                                                                      num_classes).float())]
    jobs = jgrad(jnp.asarray(w), jnp.asarray(x_true), jax.nn.one_hot(y_true, num_classes))
    np.testing.assert_allclose(observed[0].numpy(), np.asarray(jobs), rtol=1e-5, atol=1e-7)
    return (jgrad, jnp.asarray(w), jobs), (tgrad, tw, observed), x_true


class _AttackCfg:
    attack_iters = 400
    attack_lr = 0.1
    attack_tv_weight = 1e-4


@pytest.mark.parametrize("name,shape,classes,seed,corr", [
    ("dlg", (1, 8), 4, 0, 0.9), ("invert_gradient", (1, 6, 6, 1), 3, 1, 0.4)])
def test_gradient_inversion_recovers_the_input(name, shape, classes, seed, corr):
    (jg, jw, jobs), (tg, tw, tobs), x_true = _lr_problem(shape, classes, seed)
    ja = jatk_facade.FedMLAttacker.get_instance()
    ta = tatk_facade.FedMLAttacker.get_instance()
    for facade in (ja, ta):
        facade.init(types.SimpleNamespace(enable_attack=True, attack_type=name,
                                          **{k: v for k, v in vars(_AttackCfg).items()
                                             if not k.startswith("_")}))
    jx, _ = ja.reconstruct_data(jobs, (jg, jw, shape, classes))
    tx, _ = ta.reconstruct_data(tobs, (tg, tw, shape, classes))
    for rx in (np.asarray(jx), tx.numpy()):
        assert abs(np.corrcoef(rx.ravel(), x_true.ravel())[0, 1]) > corr
    img = np.random.default_rng(0).normal(size=(2, 5, 6, 3)).astype(np.float32)
    np.testing.assert_allclose(float(tgi.total_variation(torch.from_numpy(img))),
                               float(jgi.total_variation(jnp.asarray(img))), rtol=1e-6)


def test_reveal_labels_mask_is_jax_mask():
    g = np.asarray([[-0.5, -0.2], [0.3, 0.1], [-0.1, -0.4]], np.float32)
    np.testing.assert_array_equal(tgi.reveal_labels_from_gradients(torch.from_numpy(g)).numpy(),
                                  np.asarray(jgi.reveal_labels_from_gradients(jnp.asarray(g))))
    tree = jtree(np.random.default_rng(4))
    c = cfg()
    np.testing.assert_array_equal(
        tgi.RevealingLabelsFromGradientsAttack(c).reconstruct_data(params_from_jax(tree)).numpy(),
        np.asarray(jgi.RevealingLabelsFromGradientsAttack(c).reconstruct_data(
            jax.tree.map(jnp.asarray, tree))))


# --- end to end ----------------------------------------------------------------

def _byzantine_run(pkg, defense):
    kw = dict(model="lr", dataset="mnist", comm_round=4, epochs=1, client_num_in_total=4,
              client_num_per_round=4, enable_attack=True, attack_type="byzantine",
              attack_mode="random", byzantine_client_num=1)
    if defense:
        kw.update(enable_defense=True, defense_type=defense, krum_param_m=2)
    if pkg is fedml_tpu:
        return fedml_tpu.run_simulation(args=jdefault_config("simulation", **kw))["test_acc"]
    return fedml_tpu_torch.run_simulation(
        args=fedml_tpu_torch.default_config("simulation", using_gpu=False, **kw))["test_acc"]


def test_defense_end_to_end_under_byzantine_attack():
    """JAX's test_defense_end_to_end_under_byzantine_attack on the port,
    with JAX's threshold, beside JAX's own run: multi-Krum keeps the
    attacker out, so the port's defended run is JAX's to f32 noise."""
    defended, undefended = _byzantine_run(fedml_tpu_torch, "multi_krum"), _byzantine_run(
        fedml_tpu_torch, None)
    assert defended > 0.75 and defended > undefended
    assert abs(defended - _byzantine_run(fedml_tpu, "multi_krum")) <= 2 / 2000


def test_cross_silo_defense_under_attack_tracks_jax():
    """The cross-silo front over INMEMORY, 4 silos, the server's hooks
    flipping silo 1's upload and multi-Krum screening it, against JAX's
    federation from the same initial params: each round's eval within the
    LR federation's tolerances (tests/test_torch_cross_silo.py), the
    global within 1e-5 of its scale. With contribution on, the port values
    every silo each round (R9: JAX's hook fails there)."""
    from tests.test_torch_cross_silo import (LR, _assert_hist_close, _from_jax_params, _jax_p0,
                                             _max_err_of_scale, _run_jax, _run_port)

    kw = dict(LR, client_num_in_total=4, client_num_per_round=4, enable_attack=True,
              attack_type="byzantine", attack_mode="flip", byzantine_client_num=1,
              enable_defense=True, defense_type="multi_krum", krum_param_m=2)
    p0 = _jax_p0(kw)
    _, ref_hist, ref_w = _run_jax("tsec_jax_cs", kw)
    _, hist, w = _run_port("tsec_port_cs", kw, prepare=_from_jax_params(p0))
    _assert_hist_close(hist, ref_hist, rtol=1e-5, acc_slack=1)
    assert _max_err_of_scale(params_to_jax(w), ref_w) <= 1e-5
    fed, _, _ = _run_port("tsec_port_cs_contrib", dict(kw, enable_contribution=True,
                                                       contribution_alg="shapley"))
    history = fed.server.aggregator.aggregator._contribution_manager.get_history()
    assert len(history) == kw["comm_round"] and all(len(h) == 2 for h in history)
