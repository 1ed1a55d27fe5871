"""The LLM trainer's mesh against the JAX package's sharded step, on the CPU.

``fedml_tpu_torch/parallel/{fsdp,ring_attention,mesh,multihost}.py`` and
the sharded MoE against ``fedml_tpu/parallel/{fsdp,ring_attention}.py``
and ``fedml_tpu/models/moe.py``. The port's ranks are gloo processes on the
CPU started by ``tools/launch_silo.py``, one group a world size (a
module-scoped fixture: 2 ranks for fsdp, tp, sp, ep, ring attention at sp
2 and the MoE dispatch under dp and sp; 4 ranks for fsdp x tp and ring
attention at sp 4; the xdist workers share one group a world size), each
rank pinned to one torch thread; no fixed port is bound. The JAX side runs
in this process on the 8-device CPU mesh that ``tests/conftest.py`` forces;
the port's ranks do not use it. Inputs come from seeded numpy generators;
the JAX params are converted.

Tolerances:

- a trainer case: 2 steps of ``LLMTrainer`` (float64 compute; JAX's and
  the port's logits are f32 and so is their CE, and the MoE router is f32
  in both) against JAX's ``LLMTrainer`` on the same mesh shape
  (``make_fsdp_train_step``), its loss each step within 1e-6 relative and
  the whole model's update within 1e-5 relative (L2) of JAX's (measured
  5e-7 to 1.1e-6). Two cases carry f32 arithmetic into the gradient and
  are held to 1e-4: sp, where JAX's step runs in f32 (XLA's SPMD
  partitioner aborts on its ring step under x64) and its ring accumulates
  in f32 (measured 1.0e-5), and ep, whose MoE gates come from the f32
  router softmax in both packages (measured 3.4e-5). Under fsdp=2 each
  rank's parameter shards are at most 0.55 of the model's bytes.
- ring attention: forward within atol 2e-5 and grads within 5e-5 of JAX's
  ``ring_attention`` (f32, JAX's own tolerances against the plain
  attention), zigzag and contiguous at sp 2 and 4, and the odd local block
  falling back to contiguous.
- the MoE under dp=2 and sp=2 (float64): each rank's dispatch equal to the
  global dispatch's rows for its tokens (so exactly the same tokens are
  dropped), outputs within 1e-12, aux within f32 rounding (rtol 1e-6).
- the sharded causal loss: the shards' parts (each a sum in f32, the
  port's CE dtype as JAX's logits') sum to the unsharded loss and to JAX's
  within 1e-6 relative.
- the FedLLM client over fsdp=2: one round's adapters within 1e-5
  relative (L2) of the same round by one rank with the mesh's global batch,
  and the adapters its local-DP hooks take equal to the ones it uploads.

The MoE's dispatch is read by wrapping ``models/moe.py``'s ``route`` and
``dispatch_from`` for the call (:func:`recording_routing`); the model has
no recording option.
"""

import contextlib
import dataclasses
import fcntl
import json
import os
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models import moe as jmoe
from fedml_tpu.models import transformer as jt
from fedml_tpu.parallel import fsdp as jfsdp
from fedml_tpu.parallel.mesh import create_mesh
from fedml_tpu.parallel.ring_attention import ring_attention as j_ring
from fedml_tpu.train.llm import configurations as jc
from fedml_tpu.train.llm import llm_trainer as jlt
from fedml_tpu_torch.models import moe as tmoe
from fedml_tpu_torch.models.convert import flax_name, params_from_jax
from fedml_tpu_torch.parallel import fsdp as tfsdp
from fedml_tpu_torch.train.llm import configurations as tc
from fedml_tpu_torch.train.llm import llm_trainer as tlt
from fedml_tpu_torch.tools.launch_silo import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 180
LOSS_RTOL = 1e-6
UPDATE_RTOL = {"sp": 1e-4, "ep": 1e-4}
UPDATE_RTOL_DEFAULT = 1e-5
JAX_F32 = ("sp",)

MODEL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
             seq_len=16, lora_rank=0, remat=True)
EXP = dict(max_steps=2, per_device_batch_size=1, learning_rate=1e-2, warmup_steps=1)
CASES = {
    "fsdp": (dict(fsdp=2), {}),
    "tp": (dict(tp=2), dict(lora_rank=2)),
    "sp": (dict(sp=2), dict(attention_impl="ring")),
    "ep": (dict(ep=2), dict(moe_experts=4)),
    "fsdp_tp": (dict(fsdp=2, tp=2), dict(lora_rank=2, moe_experts=4)),
}
WORLD = {"fsdp": 2, "tp": 2, "sp": 2, "ep": 2, "fsdp_tp": 4}
RING = {2: [("zigzag", 32), ("contiguous", 32)],
        4: [("zigzag", 32), ("contiguous", 32), ("zigzag", 28)]}
MOE_MESH = {"dp": ((2, 1), ("dp", "fsdp")), "sp": ((1, 1, 2), ("dp", "fsdp", "sp"))}
MOE_GEOM = dict(B=4, T=8, D=16, F=32, E=4, capacity_factor=0.5)
CLIENT = {"client_fsdp": dict(fsdp=2, per_device_batch_size=1)}
CLIENT_ARGS = dict(lora_rank=2, local_steps=2, learning_rate=1e-2, warmup_steps=1)
CLIENT_BLOCKS = 6


@contextlib.contextmanager
def recording_routing(moe_module):
    """Within the block, every MoE call's router logits and dispatch are
    appended to the yielded list (``models/moe.py``'s ``route`` and
    ``dispatch_from`` wrapped, then restored)."""
    seen = []
    route, dispatch_from = moe_module.route, moe_module.dispatch_from

    def recording_route(logits):
        seen.append({"logits": logits.detach()})
        return route(logits)

    def recording_dispatch_from(*args):
        dispatch, combine = dispatch_from(*args)
        seen[-1]["dispatch"] = dispatch.detach()
        return dispatch, combine

    moe_module.route, moe_module.dispatch_from = recording_route, recording_dispatch_from
    try:
        yield seen
    finally:
        moe_module.route, moe_module.dispatch_from = route, dispatch_from


def _client(args_over, out_dir):
    """A FedLLM client of the mesh MODEL with adapters, float64 compute,
    its params from seed 0 and a non-zero lora_b from a seeded generator (so
    lora_a has a gradient from the first step)."""
    from fedml_tpu_torch.train.llm.fed_llm_trainer import LLMClientTrainer

    args = types.SimpleNamespace(**{**MODEL, **CLIENT_ARGS, **args_over, "output_dir": out_dir})
    client = LLMClientTrainer(args, device="cpu")
    client.llm.cfg = dataclasses.replace(client.llm.cfg, dtype=torch.float64)
    client.llm._build(client.llm.init_params(seed=0).to(torch.float64))
    rng = np.random.default_rng(5)
    client.llm.sharded.load_full_state({
        n: torch.from_numpy(rng.normal(0, 0.05, shape)) for n, shape in
        client.llm.sharded.full_shapes.items() if n.endswith("lora_b")})
    return client


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _jax_params(case):
    """JAX's init of a case's model (float64 under x64; the MoE stacks f32)."""
    _, model_over = CASES[case]
    geom = {**MODEL, **model_over}
    cfg = jt.TransformerConfig(dtype=jnp.float64, max_seq_len=geom["seq_len"],
                               **{k: v for k, v in geom.items() if k not in ("seq_len",)})
    with jax.enable_x64(True):
        p = jax.device_get(jt.TransformerLM(cfg).init(jax.random.PRNGKey(1),
                                                      jnp.zeros((1, 8), jnp.int32))["params"])
    rng = np.random.default_rng(2)
    # non-zero lora_b, so the adapters' paths through tp carry gradient both ways
    return {"/".join(path): (rng.normal(0, 0.05, v.shape) if path[-1] == "lora_b"
                             else np.asarray(v)) for path, v in _flat(p)}


def _batches(case):
    n = WORLD[case]
    rng = np.random.default_rng(3)
    toks = rng.integers(0, MODEL["vocab_size"], (2, n, MODEL["seq_len"])).astype(np.int32)
    return [(toks[i], np.ones_like(toks[i], np.float32)) for i in range(2)]


def _unflat(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, leaf = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


RANK_WORKER = textwrap.dedent(
    """
    import dataclasses, json, os, sys
    sys.path.insert(0, os.environ["REPO_ROOT"])
    sys.path.insert(0, os.path.join(os.environ["REPO_ROOT"], "tests"))
    os.environ["FEDML_DEVPERF"] = "0"
    import numpy as np, torch
    torch.set_num_threads(1)
    from fedml_tpu_torch.models import moe as tmoe
    from fedml_tpu_torch.models.convert import params_from_jax
    from fedml_tpu_torch.parallel import multihost as mh
    from fedml_tpu_torch.parallel.mesh import RankMesh
    from fedml_tpu_torch.parallel.ring_attention import active_mesh, ring_attention
    from fedml_tpu_torch.train.llm import configurations as tc
    from fedml_tpu_torch.train.llm import llm_trainer as tlt
    from test_torch_llm_mesh import _client, recording_routing

    out_dir = sys.argv[1]
    spec = json.load(open(os.path.join(out_dir, "spec.json")))
    data = np.load(os.path.join(out_dir, "inputs.npz"))
    assert mh.init_distributed(device="cpu")
    rank, world = mh.process_index(), mh.process_count()
    res = {"trainer": {}, "ring": {}, "moe": {}, "client": {}}

    def unflat(prefix):
        out = {}
        for key in data.files:
            if key.startswith(prefix):
                node = out
                *head, leaf = key[len(prefix):].split("/")
                for k in head:
                    node = node.setdefault(k, {})
                node[leaf] = data[key]
        return out

    for case, (axes, model_over) in spec["trainer"].items():
        ma = tc.ModelArguments(**{**spec["model"], **model_over})
        ea = tc.ExperimentArguments(output_dir=os.path.join(out_dir, case), **spec["exp"],
                                    **axes)
        tr = tlt.LLMTrainer(ma, tc.DatasetArguments(), ea, device="cpu")
        tr.cfg = dataclasses.replace(tr.cfg, dtype=torch.float64)
        model = tr.init_params(seed=0).to(torch.float64)
        model.load_state_dict(params_from_jax(unflat(case + "/p0/")))
        tr._build(model)
        losses = []
        for i in range(2):
            b = (data[f"{case}/tokens{i}"], data[f"{case}/mask{i}"])
            losses.append(tr.train(iter([b]))["final_loss"])
        named = tr.named_params()
        row = {"losses": losses, "resident": tr.sharded.resident_bytes(),
               "full": tr.sharded.full_bytes(), "stats": mh.collective_stats()}
        if rank == 0:
            row["named"] = params_from_jax(named)
        res["trainer"][case] = row

    mesh = RankMesh((world,), ("sp",))
    for layout, t in spec["ring"]:
        key = f"{layout}_{t}"
        q, k, v, g = (torch.from_numpy(data[f"ring{world}_{key}/{n}"]).float().requires_grad_(n != "g")
                      for n in "qkvg")
        tl = t // world
        sl = slice(rank * tl, (rank + 1) * tl)
        ql, kl, vl = (x[:, sl].detach().clone().requires_grad_() for x in (q, k, v))
        out = ring_attention(ql, kl, vl, mesh, layout=layout)
        (out * g[:, sl]).sum().backward()
        res["ring"][key] = {"out": out.detach(), "dq": ql.grad, "dk": kl.grad, "dv": vl.grad}

    for case, (shape, names) in spec["moe"].items():
        gm = spec["moe_geom"]
        cfg = tmoe.MoEConfig(n_experts=gm["E"], capacity_factor=gm["capacity_factor"],
                             d_model=gm["D"], d_ff=gm["F"], dtype=torch.float64)
        mod = tmoe.MoEMLP(cfg).to(torch.float64)
        mod.load_state_dict({n: torch.from_numpy(data["moe/" + n]) for n in
                             ("router", "w_gate", "w_up", "w_down")})
        m = RankMesh(shape, names)
        x = torch.from_numpy(data["moe/x"])
        bl = x.shape[0] // m.axis_size("dp", "fsdp")
        tl = x.shape[1] // m.axis_size("sp")
        b0, t0 = m.index("dp", "fsdp") * bl, m.index("sp") * tl
        with active_mesh(m), recording_routing(tmoe) as seen:
            y, aux = mod(x[b0:b0 + bl, t0:t0 + tl])
        res["moe"][case] = {"y": y.detach(), "aux": float(aux), "b0": b0, "t0": t0,
                            "dispatch": seen[0]["dispatch"]}

    for case, axes in spec["client"].items():
        client = _client(axes, os.path.join(out_dir, case))
        client.train(data["client/blocks"])
        res["client"][case] = {"up": params_from_jax(client.get_model_params()),
                               "dp_state": client._adapter_state(),
                               "batch": client.llm.exp_args.per_device_batch_size
                               * client.llm.mesh.size}
    mh.shutdown_distributed()
    torch.save(res, os.path.join(out_dir, f"result_{rank}.pt"))
    """
)


def _spawn(tmp_path, world):
    spec = {"model": MODEL, "exp": EXP, "moe_geom": MOE_GEOM,
            "trainer": {c: CASES[c] for c in CASES if WORLD[c] == world},
            "ring": RING[world], "moe": MOE_MESH if world == 2 else {},
            "client": CLIENT if world == 2 else {}}
    inputs = {}
    for case in spec["trainer"]:
        for path, v in _jax_params(case).items():
            inputs[f"{case}/p0/{path}"] = v
        for i, (t, m) in enumerate(_batches(case)):
            inputs[f"{case}/tokens{i}"], inputs[f"{case}/mask{i}"] = t, m
    for layout, t in RING[world]:
        rng = np.random.default_rng(t + world)
        for n in "qkvg":
            inputs[f"ring{world}_{layout}_{t}/{n}"] = rng.standard_normal((1, t, 2, 8)).astype(
                np.float32)
    g = MOE_GEOM
    rng = np.random.default_rng(9)
    inputs["moe/x"] = rng.standard_normal((g["B"], g["T"], g["D"]))
    router = rng.standard_normal((g["D"], g["E"])) * 0.3
    router[:, 0] += 0.4  # a favoured expert: its queue overflows across the ranks
    inputs["moe/router"] = router.astype(np.float32)
    for n, shape in (("w_gate", (g["E"], g["D"], g["F"])), ("w_up", (g["E"], g["D"], g["F"])),
                     ("w_down", (g["E"], g["F"], g["D"]))):
        inputs["moe/" + n] = rng.standard_normal(shape) * 0.2
    inputs["client/blocks"] = rng.integers(0, MODEL["vocab_size"], (CLIENT_BLOCKS,
                                                                    MODEL["seq_len"])).astype(
        np.int32)
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    np.savez(tmp_path / "inputs.npz", **inputs)
    script = tmp_path / "rank_main.py"
    script.write_text(RANK_WORKER)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(REPO_ROOT=ROOT, FEDML_MODELWATCH="0")
    rcs = launch([sys.executable, str(script), str(tmp_path)], world, env=env,
                 log_dir=str(tmp_path / "logs")).wait(DEADLINE_S)
    errs = [(tmp_path / "logs" / f"rank{r}.err").read_text()[-3000:] for r in range(world)]
    assert rcs == [0] * world, errs
    return [torch.load(tmp_path / f"result_{r}.pt") for r in range(world)], inputs


def _spawn_once(tmp_path_factory, world):
    """One group of ``world`` ranks for the whole session: the xdist workers
    share pytest's base temp directory, and the first to take the lock
    spawns the ranks while the others wait and read its results."""
    base = tmp_path_factory.getbasetemp()
    shared = base.parent if base.name.startswith("popen-gw") else base
    run = shared / f"torch_llm_mesh_{world}"
    run.mkdir(exist_ok=True)
    with open(run / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (run / "done").exists():
            _spawn(run, world)
            (run / "done").write_text("ok")
    inputs = dict(np.load(run / "inputs.npz"))
    return [torch.load(run / f"result_{r}.pt") for r in range(world)], inputs


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _spawn_once(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _spawn_once(tmp_path_factory, 4)


def _jax_steps(case, inputs, tmp_path):
    """JAX's LLMTrainer on the case's mesh (make_fsdp_train_step), float64;
    the sp case in f32: XLA's SPMD partitioner aborts on JAX's ring step
    under x64 (``spmd_partitioner_util.h:117``, a scalar of the wrong
    element type)."""
    axes, model_over = CASES[case]
    p0 = _unflat({k[len(case) + 4:]: v for k, v in inputs.items()
                  if k.startswith(case + "/p0/")})
    x64 = case not in JAX_F32
    dtype = jnp.float64 if x64 else jnp.float32
    with jax.enable_x64(x64):
        jtr = jlt.LLMTrainer(jc.ModelArguments(**{**MODEL, **model_over}), jc.DatasetArguments(),
                             jc.ExperimentArguments(output_dir=str(tmp_path / "jax"), **EXP,
                                                    **axes),
                             devices=jax.devices()[:WORLD[case]])
        jtr.cfg = dataclasses.replace(jtr.cfg, dtype=dtype)
        jtr.model = jt.TransformerLM(jtr.cfg)
        jtr._build(jax.tree.map(lambda v: jnp.asarray(v, dtype if v.dtype == np.float64
                                                      else v.dtype), p0))
        losses = [jtr.train(iter([b]))["final_loss"] for b in _batches(case)]
        return losses, jax.device_get(jtr.params), p0


@pytest.mark.parametrize("case", ["fsdp", "tp", "sp", "ep", "fsdp_tp"])
def test_sharded_steps_match_jax(case, request, tmp_path):
    results, inputs = request.getfixturevalue("four_ranks" if WORLD[case] == 4 else "two_ranks")
    want_losses, want_params, p0 = _jax_steps(case, inputs, tmp_path)
    for r, res in enumerate(results):
        got = res["trainer"][case]["losses"]
        np.testing.assert_allclose(got, want_losses, rtol=LOSS_RTOL, err_msg=f"rank {r}")
    named = results[0]["trainer"][case]["named"]
    want = params_from_jax(want_params)
    start = params_from_jax(p0)
    assert named.keys() == want.keys()
    num = den = 0.0
    for n in want:
        num += float((named[n].double() - want[n].double()).pow(2).sum())
        den += float((want[n].double() - start[n].double()).pow(2).sum())
    assert den > 0
    rel = (num / den) ** 0.5
    assert rel <= UPDATE_RTOL.get(case, UPDATE_RTOL_DEFAULT), f"{case}: update rel {rel:.3g}"
    if case == "fsdp":
        for res in results:
            row = res["trainer"][case]
            assert row["resident"] <= 0.55 * row["full"], row["resident"] / row["full"]
    if case == "sp":
        for res in results:
            assert res["trainer"]["sp"]["stats"]["ring_shift"]["calls"] > 0


@pytest.mark.parametrize("world,layout,t", [(2, "zigzag", 32), (2, "contiguous", 32),
                                            (4, "zigzag", 32), (4, "contiguous", 32),
                                            (4, "zigzag", 28)])
def test_ring_attention_matches_jax(world, layout, t, request):
    """Forward and grads against JAX's ring_attention on a CPU mesh of the
    same width; T=28 over 4 ranks is an odd local block (zigzag falls back
    to contiguous in both)."""
    results, inputs = request.getfixturevalue("four_ranks" if world == 4 else "two_ranks")
    q, k, v, g = (inputs[f"ring{world}_{layout}_{t}/{n}"] for n in "qkvg")
    mesh = create_mesh((world,), ("sp",))

    def loss(q, k, v):
        return jnp.sum(j_ring(q, k, v, mesh, layout=layout) * g)

    out = np.asarray(jax.jit(lambda q, k, v: j_ring(q, k, v, mesh, layout=layout))(q, k, v))
    grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    key = f"{layout}_{t}"
    cat = lambda n: torch.cat([res["ring"][key][n] for res in results], dim=1).numpy()  # noqa: E731
    np.testing.assert_allclose(cat("out"), out, atol=2e-5)
    for n, want in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(cat(n), np.asarray(want), atol=5e-5, err_msg=n)


@pytest.mark.parametrize("case", ["dp", "sp"])
def test_sharded_moe_drops_the_global_dispatch_s_tokens(case, two_ranks):
    """The MoE with its batch (dp) or sequence (sp) split over 2 ranks routes
    as the global batch does: capacity from the global N, each token's
    place in the global [B, T] order, global aux statistics."""
    results, inputs = two_ranks
    g = MOE_GEOM
    mod = tmoe.MoEMLP(tmoe.MoEConfig(n_experts=g["E"], capacity_factor=g["capacity_factor"],
                                     d_model=g["D"], d_ff=g["F"], dtype=torch.float64))
    mod.to(torch.float64)
    mod.load_state_dict({n: torch.from_numpy(inputs["moe/" + n])
                         for n in ("router", "w_gate", "w_up", "w_down")})
    x = torch.from_numpy(inputs["moe/x"])
    with recording_routing(tmoe) as seen:
        y, aux = mod(x)
    disp = seen[0]["dispatch"].view(g["B"], g["T"], g["E"], -1)
    dropped = int(tmoe.dropped_tokens(seen[0]["dispatch"]))
    assert dropped > 0  # the case overflows
    # a dropped token's output row is exactly zero (what the smoke counts)
    assert int((y.reshape(-1, g["D"]) == 0).all(dim=-1).sum()) == dropped
    # the global dispatch is JAX's on the same router logits
    cap = tmoe.capacity_for(g["B"] * g["T"], g["E"], g["capacity_factor"])
    jd, _, jaux = jmoe.moe_dispatch(jnp.asarray(seen[0]["logits"].numpy()), cap)
    np.testing.assert_array_equal(disp.reshape(-1, g["E"], cap).numpy(), np.asarray(jd))
    for res in results:
        got = res["moe"][case]
        bl, tl = (g["B"] // 2, g["T"]) if case == "dp" else (g["B"], g["T"] // 2)
        b0, t0 = got["b0"], got["t0"]
        want = disp[b0:b0 + bl, t0:t0 + tl].reshape(-1, g["E"], cap)
        assert torch.equal(got["dispatch"], want)
        np.testing.assert_allclose(got["y"].numpy(),
                                   y[b0:b0 + bl, t0:t0 + tl].detach().numpy(), atol=1e-12)
        np.testing.assert_allclose(got["aux"], float(aux), rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_sharded_causal_loss_sums_to_the_unsharded_loss(masked):
    """Each rank's last position predicts the next rank's first token, the
    global last position is dropped, the mean is the global one."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((4, 12, 20)) * 3
    toks = rng.integers(0, 20, (4, 12)).astype(np.int64)
    mask = (rng.random((4, 12)) > 0.3).astype(np.float64) if masked else None
    targets, tmask, denom = tfsdp.shifted_targets(
        torch.from_numpy(toks), None if mask is None else torch.from_numpy(mask))
    parts = 0.0
    for rows in (slice(0, 2), slice(2, 4)):
        for pos in (slice(0, 4), slice(4, 8), slice(8, 12)):
            parts += float(tfsdp.sharded_causal_lm_loss(
                torch.from_numpy(logits[rows, pos]), targets[rows, pos], tmask[rows, pos],
                denom))
    want = float(tfsdp.causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(toks),
                                      None if mask is None else torch.from_numpy(mask)))
    assert abs(parts - want) <= 1e-6 * abs(want)
    jwant = float(jfsdp.causal_lm_loss(jnp.asarray(logits, jnp.float32), jnp.asarray(toks),
                                       None if mask is None else jnp.asarray(mask)))
    assert abs(parts - jwant) <= 1e-6 * abs(jwant)


def test_param_specs_match_jax_rules():
    """The port's spec of every state-dict leaf is JAX's param_shardings of
    its flax path, flipped for a Dense weight and not for the MoE stacks."""
    cfg = jt.TransformerConfig(dtype=jnp.float32, **{**{k: v for k, v in MODEL.items()
                                                        if k != "seq_len"}, "lora_rank": 2,
                                                     "moe_experts": 4})
    params = jax.device_get(jt.TransformerLM(cfg).init(jax.random.PRNGKey(0),
                                                       jnp.zeros((1, 8), jnp.int32))["params"])
    mesh = create_mesh((2, 2, 2), ("fsdp", "tp", "ep"))
    jspecs = dict(_flat(jax.tree.map(lambda s: tuple(s.spec),
                                     jfsdp.param_shardings(params, mesh),
                                     is_leaf=lambda s: hasattr(s, "spec"))))
    state = params_from_jax(params)
    shape = {"fsdp": 2, "tp": 2, "ep": 2}
    flips = 0
    for name, t in state.items():
        got = tfsdp.torch_spec(name, tuple(t.shape), shape)
        want = jspecs[tuple(flax_name(name).split("/"))]
        want = want + (None,) * (t.ndim - len(want))
        if name.endswith(".weight") and t.ndim == 2:  # a Dense kernel: [out, in] here
            want, flips = tuple(reversed(want)), flips + 1
        assert got == want, (name, got, want)
    assert flips > 0
    assert tfsdp.torch_spec("layer_0.moe_mlp.w_down", (4, 64, 32), shape) == ("ep", "tp", "fsdp")
    # the port's nested form equals JAX's on the same tree
    assert tfsdp.param_shardings(params, shape)["layer_0"]["attn"]["q_proj"]["kernel"] == \
        jspecs[("layer_0", "attn", "q_proj", "kernel")]


def test_fedllm_client_over_a_mesh_matches_one_rank(two_ranks, tmp_path, monkeypatch):
    """A FedLLM silo's client over fsdp=2 draws the mesh's global batch each
    step (per_device_batch_size times the mesh's size) and uploads the
    adapters one rank trains on that batch; its local-DP hooks take the
    whole adapters, gathered. devperf and modelwatch are off, as in the
    ranks: they take no float64 model."""
    monkeypatch.setenv("FEDML_DEVPERF", "0")
    monkeypatch.setenv("FEDML_MODELWATCH", "0")
    results, inputs = two_ranks
    for case, axes in CLIENT.items():
        ref = _client({"per_device_batch_size": 2}, str(tmp_path / case))
        start = params_from_jax(ref.get_model_params())
        ref.train(inputs["client/blocks"])
        want = params_from_jax(ref.get_model_params())
        for r, res in enumerate(results):
            got = res["client"][case]
            assert got["batch"] == 2
            assert got["up"].keys() == want.keys()
            num = sum(float((got["up"][n].double() - want[n].double()).pow(2).sum())
                      for n in want)
            den = sum(float((want[n].double() - start[n].double()).pow(2).sum()) for n in want)
            assert den > 0
            assert (num / den) ** 0.5 <= UPDATE_RTOL_DEFAULT, (case, r, (num / den) ** 0.5)
            assert got["dp_state"].keys() == want.keys()
            for n in want:
                assert torch.equal(got["dp_state"][n], got["up"][n]), n


def test_pp_and_server_mesh_still_raise(tmp_path):
    for over in (dict(pp=2),):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tlt.LLMTrainer(tc.ModelArguments(**MODEL), tc.DatasetArguments(),
                           tc.ExperimentArguments(output_dir=str(tmp_path), **over), device="cpu")
    exp = tc.ExperimentArguments(output_dir=str(tmp_path))
    exp.server_mesh = "auto"
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tlt.LLMTrainer(tc.ModelArguments(**MODEL), tc.DatasetArguments(), exp, device="cpu")
