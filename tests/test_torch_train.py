"""The port's training substrate against the JAX package, on the CPU:
AdamW, schedules, gradient compression, checkpoints (both ways, byte for
byte), the prefetch pipeline, the train step and the trainer CLI.

Weights and optimiser state go into the port through ``convert``; batches
and injected gradients are the reference's or numpy draws. Tolerances: one
``AdamW.update`` (updates and moments) rtol 1e-6 (the reference's
formula, one rounding per operation; the global norm sums in another
order, so the clip's scale may differ in its last bit), with an absolute
floor of two f32 ulps of the leaf's largest value (a sum such as
``b1 m + (1 - b1) g`` may cancel to far below its terms, whose last-bit
rounding is then all that differs); a 3-step trajectory's losses rtol
1e-4; compression's int8 codes exact and its error buffers within 1e-6;
schedules exact, except that a cosine's value may differ in its last bit
(the two libraries' f32 ``cos`` round differently); checkpoints byte for
byte.
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402,E501
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.optim.adamw import AdamWState as JaxAdamWState  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.checkpoint import (  # noqa: E402
    flat_state, leaf_paths, nest_state)
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import AdamW, AdamWState, apply_updates  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close_one_update(got, want, name):
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=2 * 2**-23 * np.abs(want).max(),
                               err_msg=name)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat_t(tree) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in flat_state(tree)
            .items()}


def _dlrm():
    jcfg = jconfigs.get_arch("dlrm-rm2").make_reduced()
    tcfg = tconfigs.get_arch("dlrm-rm2").make_reduced()
    return jcfg, tcfg, jrec.init_params(jcfg, jax.random.PRNGKey(0))


def _injected_state(params, seed):
    rng = np.random.default_rng(seed)
    like = _np(params)

    def draw(scale, positive=False):
        return jax.tree.map(lambda a: (np.abs if positive else np.asarray)(
            rng.standard_normal(a.shape).astype(np.float32) * scale), like)

    grads = draw(0.5)
    state = JaxAdamWState(step=np.int32(4), mu=draw(0.01),
                          nu=draw(1e-4, positive=True))
    return grads, state


@pytest.mark.parametrize("clip,lr", [
    (1.0, 1e-3), (None, 1e-3), (1e3, 1e-3),
    (1.0, "warmup_cosine")])
def test_adamw_update_matches_the_reference(clip, lr):
    _, _, params = _dlrm()
    grads, state = _injected_state(params, 0)
    jlr = (jsched.linear_warmup_cosine(1e-2, 3, 20)
           if lr == "warmup_cosine" else lr)
    tlr = (tsched.linear_warmup_cosine(1e-2, 3, 20)
           if lr == "warmup_cosine" else lr)
    jopt = JaxAdamW(learning_rate=jlr, clip_norm=clip)
    upd_j, st_j = jopt.update(jax.tree.map(jnp.asarray, grads),
                              jax.tree.map(jnp.asarray, state), params)
    p_t = _flat_t(_np(params))
    st_t = convert.adamw_state_from_arrays(state, device="cpu")
    upd_t, st_t2 = AdamW(learning_rate=tlr, clip_norm=clip).update(
        _flat_t(grads), st_t, p_t)
    assert int(st_t2.step) == int(st_j.step) == 5
    for name, u in flat_state(_np(upd_j)).items():
        _close_one_update(upd_t[name].numpy(), u, name)
    for which in ("mu", "nu"):
        for name, m in flat_state(_np(getattr(st_j, which))).items():
            _close_one_update(getattr(st_t2, which)[name].numpy(), m, name)
    before = {k: v.clone() for k, v in p_t.items()}
    apply_updates(p_t, upd_t)
    for name, p in p_t.items():
        assert torch.equal(p, before[name] + upd_t[name])


def test_adamw_update_in_slices_equals_one_pass(monkeypatch):
    """The update runs over slices of CHUNK elements: the bits do not
    depend on the slicing (elementwise operations only)."""
    _, _, params = _dlrm()
    grads, state = _injected_state(params, 1)
    out = []
    for chunk in (1 << 24, 7):
        monkeypatch.setattr("repro_torch.optim.adamw.CHUNK", chunk)
        upd, st = AdamW(learning_rate=1e-3).update(
            _flat_t(grads), convert.adamw_state_from_arrays(
                state, device="cpu"), _flat_t(_np(params)))
        out.append((upd, st))
    for name in out[0][0]:
        assert torch.equal(out[0][0][name], out[1][0][name])
        assert torch.equal(out[0][1].nu[name], out[1][1].nu[name])


def test_schedules_are_exact_at_sample_steps():
    warm = 10
    pairs = [  # (reference, port, steps whose value involves no cosine)
        (jsched.constant(3e-4), tsched.constant(3e-4), "all"),
        (jsched.cosine_decay(1e-3, 100), tsched.cosine_decay(1e-3, 100),
         "none"),
        (jsched.cosine_decay(2e-3, 37, 0.0),
         tsched.cosine_decay(2e-3, 37, 0.0), "none"),
        (jsched.linear_warmup_cosine(1e-2, warm, 100),
         tsched.linear_warmup_cosine(1e-2, warm, 100), "warmup"),
    ]
    n_cos_exact = n_cos = 0
    for jfn, tfn, plain in pairs:
        for s in (0, 1, 5, 9, 10, 11, 37, 50, 99, 100, 150):
            want = np.asarray(jfn(jnp.asarray(s, jnp.int32)))
            got = tfn(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32 and got.shape == ()
            if plain == "all" or (plain == "warmup" and s < warm):
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=str(s))
            else:  # one ulp: the f32 cos of the two libraries
                assert abs(got.item() - float(want)) <= np.spacing(want), s
                n_cos += 1
                n_cos_exact += got.item() == float(want)
    assert n_cos_exact >= n_cos // 2, (n_cos_exact, n_cos)


def test_compression_matches_the_reference():
    rng = np.random.default_rng(2)
    grads = {"a": rng.standard_normal((33, 5)).astype(np.float32),
             "b": (rng.standard_normal(7) * 1e-3).astype(np.float32),
             "z": np.zeros(4, np.float32)}
    for x in grads.values():
        qj, sj = jcomp._quantize(jnp.asarray(x))
        qt, st = tcomp._quantize(torch.from_numpy(x))
        assert qt.dtype == torch.int8
        np.testing.assert_array_equal(qt.numpy(), qj)
        assert st.item() == float(sj)
        rec_j, res_j = jcomp.compress_decompress(jnp.asarray(x))
        rec_t, res_t = tcomp.compress_decompress(torch.from_numpy(x))
        np.testing.assert_array_equal(rec_t.numpy(), rec_j)
        np.testing.assert_allclose(res_t.numpy(), res_j, rtol=0, atol=1e-6)
    js = jcomp.init_state(grads)
    ts = tcomp.init_state({k: torch.from_numpy(v) for k, v in grads.items()})
    for rnd in range(3):  # the error buffers carry over rounds
        g = {k: (v * (rnd + 1)).astype(np.float32) for k, v in grads.items()}
        gj, js = jcomp.error_feedback_update(
            {k: jnp.asarray(v) for k, v in g.items()}, js)
        gt, ts = tcomp.error_feedback_update(
            {k: torch.from_numpy(v) for k, v in g.items()}, ts)
        for k in g:
            np.testing.assert_allclose(gt[k].numpy(), gj[k], rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(ts.error[k].numpy(), js.error[k],
                                       rtol=0, atol=1e-6)
    assert sum(float(np.abs(e).sum()) for e in js.error.values()) > 0


def _jax_trajectory(jcfg, params, steps, lr=3e-4):
    opt = JaxAdamW(learning_rate=lr)

    @jax.jit
    def step_fn(params, opt_state, batch):
        (loss, _), grads = jax.value_and_grad(
            lambda p: jrec.loss_fn(jcfg, p, batch), has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return jax.tree.map(lambda a, b: a + b, params, updates), \
            opt_state, loss

    opt_state, losses = opt.init(params), []
    for s in range(steps):
        batch = jsyn.recsys_batch(0, s, 32, jcfg.vocab_sizes, jcfg.n_dense)
        params, opt_state, loss = step_fn(params, opt_state, batch)
        losses.append(float(loss))
    return params, opt_state, losses


@pytest.mark.parametrize("arch", ["dlrm-rm2", "xdeepfm"])
def test_train_step_trajectory_matches_the_reference(arch):
    jcfg = jconfigs.get_arch(arch).make_reduced()
    tcfg = tconfigs.get_arch(arch).make_reduced()
    params = jrec.init_params(jcfg, jax.random.PRNGKey(7))
    p_j, st_j, losses_j = _jax_trajectory(jcfg, params, 3)
    model = convert.recsys_params_from_arrays(tcfg, _np(params),
                                              device="cpu")
    trainer = ttrain.Trainer(model, lambda m, b: ttrain.recsys.loss_fn(
        tcfg, m, b))
    losses_t = []
    for s in range(3):
        batch = _np(jsyn.recsys_batch(0, s, 32, jcfg.vocab_sizes,
                                      jcfg.n_dense))
        loss, _ = trainer.step({k: torch.from_numpy(np.array(v))
                                for k, v in batch.items()})
        losses_t.append(loss.item())
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    assert int(trainer.opt_state.step) == int(st_j.step) == 3
    for name, p in flat_state(_np(p_j)).items():
        np.testing.assert_allclose(trainer.params[name].detach().numpy(), p,
                                   rtol=1e-4, atol=1e-6, err_msg=name)


# -- checkpoints ------------------------------------------------------------


def _tree_pair():
    """(the reference's (params, AdamWState), the port's equal state tree)."""
    _, tcfg, params = _dlrm()
    grads, state = _injected_state(params, 3)
    jtree = (params, JaxAdamWState(step=jnp.asarray(state.step), mu=jax.tree
                                   .map(jnp.asarray, state.mu),
                                   nu=jax.tree.map(jnp.asarray, state.nu)))
    trainer = ttrain.Trainer(convert.recsys_params_from_arrays(
        tcfg, _np(params), device="cpu"), None)
    trainer.opt_state = convert.adamw_state_from_arrays(state, device="cpu")
    return jtree, trainer


def _files(d):
    return sorted(os.listdir(d))


def test_checkpoints_are_the_same_bytes_both_ways(tmp_path):
    jtree, trainer = _tree_pair()
    jm = JaxCheckpointManager(str(tmp_path / "jax"))
    tm = CheckpointManager(str(tmp_path / "port"))
    dj, dt = jm.save(6, jtree), tm.save(6, trainer.state_tree())
    assert _files(dj) == _files(dt)
    assert "1__.mu__table.npy" in _files(dt) and "1__.step.npy" in _files(dt)
    for f in _files(dj):
        if f.endswith(".npy"):
            with open(os.path.join(dj, f), "rb") as a, \
                    open(os.path.join(dt, f), "rb") as b:
                assert a.read() == b.read(), f
    mj = json.load(open(os.path.join(dj, "manifest.json")))
    mt = json.load(open(os.path.join(dt, "manifest.json")))
    assert mj == mt  # the reference writes no treedef for a NamedTuple
    assert mt["treedef"] is None
    assert [n for n, _ in leaf_paths(trainer.state_tree())] == \
        [e["name"] for e in mj["leaves"]]

    # the reference's checkpoint into the port
    fresh = ttrain.recsys_trainer(tconfigs.get_arch("dlrm-rm2")
                                  .make_reduced(), seed=9, device="cpu")
    step, tree = CheckpointManager(str(tmp_path / "jax")).restore(
        like=fresh.state_tree())
    assert step == 6
    fresh.load_state_tree(tree)
    for name, p in flat_state(_np(jtree[0])).items():
        np.testing.assert_array_equal(fresh.params[name].detach().numpy(), p)
    for name, m in flat_state(_np(jtree[1].nu)).items():
        np.testing.assert_array_equal(fresh.opt_state.nu[name].numpy(), m)
    assert fresh.opt_state.step.dtype == torch.int32
    assert int(fresh.opt_state.step) == 4

    # the port's checkpoint into the reference, with like=
    tm.save_async(8, trainer.state_tree())
    tm.wait()
    like = jax.tree.map(jnp.zeros_like, jtree)
    step, back = JaxCheckpointManager(str(tmp_path / "port")).restore(
        like=like)
    assert step == 8
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_leaves_round_trip(tmp_path):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((6, 3)).astype(np.float32))
    tree = {"w": x.to(torch.bfloat16), "b": {"c": torch.arange(3)}}
    tm = CheckpointManager(str(tmp_path / "port"))
    tm.save(1, tree)
    _, back = tm.restore(like=tree)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16),
                       tree["w"].view(torch.int16))
    assert torch.equal(back["b"]["c"], tree["b"]["c"])
    # the reference reads the port's bf16 bits, and the port the reference's
    jlike = {"w": jnp.zeros((6, 3), jnp.bfloat16),
             "b": {"c": jnp.zeros(3, jnp.int64 if jax.config.jax_enable_x64
                                  else jnp.int32)}}
    _, jback = JaxCheckpointManager(str(tmp_path / "port")).restore(
        like=jlike)
    np.testing.assert_array_equal(
        np.asarray(jback["w"]).view(np.uint16),
        tree["w"].view(torch.int16).numpy().view(np.uint16))
    jm = JaxCheckpointManager(str(tmp_path / "jax"))
    jm.save(2, {"w": jnp.asarray(x.numpy()).astype(jnp.bfloat16)})
    _, tback = CheckpointManager(str(tmp_path / "jax")).restore()
    assert torch.equal(tback["w"].view(torch.int16),
                       tree["w"].view(torch.int16))


def test_checkpoint_manager_atomicity_retention_and_async(tmp_path):
    tm = CheckpointManager(str(tmp_path), keep=2)
    x = torch.zeros(5)
    os.makedirs(tmp_path / "tmp.step_0000000009")  # a crash mid-save
    assert tm.all_steps() == [] and tm.latest_step() is None
    with pytest.raises(FileNotFoundError):
        tm.restore()
    for s in (1, 2, 3, 4):
        x.fill_(s)
        tm.save_async(s, {"x": x})
        x.fill_(-1)  # the step after a save changes the tensor in place
        tm.wait()
    assert tm.all_steps() == [3, 4]
    assert float(tm.restore(3)[1]["x"][0]) == 3.0
    assert float(tm.restore()[1]["x"][0]) == 4.0
    with pytest.raises(ValueError, match="not like"):
        tm.restore(like={"y": x})


def test_nest_state_round_trips_and_orders_like_jax():
    flat = {f"l.{i}.w": torch.zeros(1) for i in range(12)}
    flat["a"] = torch.zeros(1)
    nested = nest_state(flat)
    assert isinstance(nested["l"], list) and len(nested["l"]) == 12
    assert flat_state(nested) == flat
    jnames = [n for n, _ in leaf_paths(nested)]
    want = ["a"] + [f"l__{i}__w" for i in range(12)]  # 10 after 9, as jax
    assert jnames == want


# -- pipeline -----------------------------------------------------------------


def test_prefetch_pipeline_restarts_exactly_and_raises():
    cfg = tconfigs.get_arch("autoint").make_reduced()
    make = ttrain.batch_fn(cfg, seed=3, batch=16, device="cpu")
    pipe = tpipe.PrefetchPipeline(make)
    first = [next(pipe) for _ in range(6)]
    pipe.close()
    pipe = tpipe.PrefetchPipeline(make, start_step=3, prefetch=1)
    again = [next(pipe) for _ in range(3)]
    pipe.close()
    assert [s for s, _ in first] == list(range(6))
    for (s, a), (s2, b) in zip(first[3:], again):
        assert s == s2 and a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)

    def broken(step):
        if step == 2:
            raise KeyError("no batch")
        return make(step)

    pipe = tpipe.PrefetchPipeline(broken)
    assert next(pipe)[0] == 0 and next(pipe)[0] == 1
    with pytest.raises(KeyError):
        next(pipe)
    pipe.close()
    batch = make(0)
    half = tpipe.shard_for_host(batch, host_index=1, num_hosts=2)
    assert torch.equal(half["sparse"], batch["sparse"][8:])
    assert tpipe.shard_for_host(batch) is batch


# -- the trainer ---------------------------------------------------------------


def test_port_restart_is_bit_exact(tmp_path):
    cfg = tconfigs.get_arch("dlrm-rm2").make_reduced()
    make = ttrain.batch_fn(cfg, seed=0, batch=8, device="cpu")

    def run(trainer, start, steps):
        return [trainer.step(make(s))[0].item()
                for s in range(start, start + steps)]

    a = ttrain.recsys_trainer(cfg, seed=0, device="cpu")
    losses_a = run(a, 0, 3)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(3, a.state_tree())
    mgr.wait()
    losses_b = run(a, 3, 3)
    assert np.isfinite(losses_a + losses_b).all()

    b = ttrain.recsys_trainer(cfg, seed=1, device="cpu")
    step, tree = mgr.restore(like=b.state_tree())
    assert step == 3
    b.load_state_tree(tree)
    assert run(b, 3, 3) == losses_b
    for name, p in a.params.items():
        assert torch.equal(p, b.params[name]), name
        assert torch.equal(a.opt_state.mu[name], b.opt_state.mu[name])


def test_compressed_training_runs():
    cfg = tconfigs.get_arch("autoint").make_reduced()
    t = ttrain.recsys_trainer(cfg, seed=0, device="cpu", compress_grads=True)
    make = ttrain.batch_fn(cfg, seed=0, batch=16, device="cpu")
    losses = [t.step(make(s))[0].item() for s in range(4)]
    assert all(np.isfinite(losses))
    assert sum(float(e.abs().sum()) for e in t.comp_state.error.values()) > 0


def test_train_cli_with_resume(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ckpt = str(tmp_path / "ckpt")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "dlrm-rm2", "--reduced", "--device", "cpu", "--steps", "12",
           "--batch", "8", "--ckpt-dir", ckpt, "--ckpt-every", "5"]
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "done" in r.stdout
    assert sorted(os.listdir(ckpt)) == ["step_0000000005", "step_0000000010"]
    r2 = subprocess.run(cmd + ["--resume", "--steps", "14"],
                        capture_output=True, text=True, env=env, timeout=300)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed from step 10" in r2.stdout
    # the resumed step 10 is the uninterrupted run's step 10
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("step 10:")]
    line2 = [ln for ln in r2.stdout.splitlines()
             if ln.startswith("step 10:")]
    assert line and line2 and line[0].split(" (")[0] == \
        line2[0].split(" (")[0]


def test_train_cli_refuses_what_is_not_ported_and_has_no_fallback():
    handler = signal.getsignal(signal.SIGTERM)
    base = ["--arch", "dlrm-rm2", "--reduced", "--steps", "1"]
    with pytest.raises(NotImplementedError, match="ROADMAP A, item 3"):
        ttrain.main(base + ["--device", "cpu", "--data-shards", "2"])
    with pytest.raises(NotImplementedError, match="ROADMAP A, item 3"):
        ttrain.main(base + ["--device", "cpu", "--multihost"])
    with pytest.raises(ValueError, match="ROADMAP A, item 2"):
        ttrain.main(["--arch", "mace", "--device", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(base)
    assert signal.getsignal(signal.SIGTERM) is handler


def test_the_cli_returns_the_run():
    handler = signal.getsignal(signal.SIGTERM)
    out = ttrain.main(["--arch", "wide-deep", "--reduced", "--device", "cpu",
                       "--steps", "3", "--batch", "8"])
    assert len(out["losses"]) == len(out["step_s"]) == 3
    assert out["peak_bytes"] is None and out["start_step"] == 0
    assert out["batch_shapes"]["sparse"] == ((8, 8), torch.int32)
    assert signal.getsignal(signal.SIGTERM) is handler  # restored
    assert isinstance(out["trainer"].opt_state, AdamWState)
    assert tsyn.batch_generator(0, 1).initial_seed() == 1
