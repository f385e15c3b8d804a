"""The port's GNN training against the JAX package, on the CPU: one
``Trainer.step`` of MACE against the reference's ``value_and_grad`` +
AdamW step, the trainer's graph batches against the reference trainer's,
the CLI and its resume, checkpoints of MACE state both ways, and
``launch.model_flops`` against the reference's on every cell.

Weights come from the reference's ``init_params`` through
``convert.mace_from_arrays``. Tolerances: the step's loss rtol 1e-5 and
its parameters and moments rtol 1e-4 / atol 1e-6 (the LM and recsys
trainer tests'); batches, the CLI's resumed run, checkpoint files and
FLOP counts exactly.
"""
import dataclasses
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402,E501
from repro.data import synthetic as jsyn  # noqa: E402
from repro.launch import model_flops as jflops  # noqa: E402
from repro.launch.steps import build_plan  # noqa: E402
from repro.models import mace as jmace  # noqa: E402
from repro.optim import AdamW as JaxAdamW  # noqa: E402
from repro.optim.adamw import AdamWState as JaxAdamWState  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.checkpoint import flat_state  # noqa: E402
from repro_torch.launch import model_flops as tflops  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import mace as tmace  # noqa: E402

STEP = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _x32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _reference_batch(seed, step, B, d_feat):
    """The reference trainer's ``make_batch`` (``repro.launch.train``)."""
    return dict(jsyn.geometric_graph_batch(
        seed + step, n_nodes=16 * B, n_edges=48 * B, d_feat=d_feat,
        n_graphs=B), n_graphs=B)


@pytest.mark.parametrize("node_level", [False, True])
def test_trainer_step_matches_the_reference(node_level):
    jcfg = jconfigs.get_arch("mace").make_reduced()
    tcfg = tconfigs.get_arch("mace").make_reduced()
    params = jmace.init_params(jcfg, jax.random.PRNGKey(4))
    jb = dict(jsyn.geometric_graph_batch(4, 64, 192, jcfg.d_feat,
                                         n_graphs=4, node_level=node_level),
              n_graphs=4, node_level=node_level)
    opt = JaxAdamW(learning_rate=ttrain.LEARNING_RATE)

    @jax.jit
    def step(p, st):
        (loss, _), g = jax.value_and_grad(
            lambda q: jmace.loss_fn(jcfg, q, jb), has_aux=True)(p)
        upd, st = opt.update(g, st, p)
        return jax.tree.map(lambda a, u: a + u, p, upd), st, loss

    p_j, st_j, loss_j = step(params, opt.init(params))
    tb = {k: torch.from_numpy(np.array(v)) if hasattr(v, "shape") else v
          for k, v in jb.items()}
    model = convert.mace_from_arrays(tcfg, _np(params), device="cpu")
    trainer = ttrain.Trainer(model, lambda m, b: tmace.loss_fn(tcfg, m, b))
    loss_t, aux = trainer.step(tb)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    assert aux["loss"].item() == loss_t.item()
    assert int(trainer.opt_state.step) == int(st_j.step) == 1
    for name, p in flat_state(_np(p_j)).items():
        np.testing.assert_allclose(trainer.params[name].detach().numpy(), p,
                                   **STEP, err_msg=name)
    for which in ("mu", "nu"):
        for name, m in flat_state(_np(getattr(st_j, which))).items():
            np.testing.assert_allclose(
                getattr(trainer.opt_state, which)[name].numpy(), m,
                **STEP, err_msg=f"{which} {name}")


@pytest.mark.parametrize("seed,B", [(0, 4), (3, 2), (11, 8)])
def test_trainer_batches_are_the_reference_trainers(seed, B):
    """``gnn_batch_fn`` gives the reference trainer's batch of each step,
    every array bit for bit, and its ``n_graphs``."""
    cfg = tconfigs.get_arch("mace").make_reduced()
    make = ttrain.family_batch_fn("gnn", cfg, seed=seed, batch=B, seq=64,
                                  device="cpu")
    for step in (0, 1, 9):
        want = _reference_batch(seed, step, B, cfg.d_feat)
        got = make(step)
        assert sorted(got) == sorted(want) and got["n_graphs"] == B
        for k, v in want.items():
            if k != "n_graphs":
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                              err_msg=k)


def _cli(tmp, steps, *extra):
    return ttrain.main(["--arch", "mace", "--reduced", "--device", "cpu",
                        "--steps", str(steps), "--batch", "4",
                        "--ckpt-dir", str(tmp), "--ckpt-every", "5",
                        *extra])


def test_mace_cli_resume_is_bit_exact(tmp_path):
    """12 steps with checkpoints at 5 and 10, then a resume from 10 to 14:
    its losses are an uninterrupted 14-step run's, bit for bit, and so are
    its final parameters; the batch carries the reference trainer's
    shapes and ``n_graphs``."""
    handler = signal.getsignal(signal.SIGTERM)
    first = _cli(tmp_path / "a", 12)
    assert first["batch_shapes"] == {
        "positions": ((64, 3), torch.float32),
        "node_feat": ((64, 8), torch.float32),
        "senders": ((192,), torch.int32),
        "receivers": ((192,), torch.int32),
        "edge_mask": ((192,), torch.float32),
        "node_mask": ((64,), torch.float32),
        "node_graph": ((64,), torch.int32),
        "target_energy": ((4,), torch.float32),
        "n_graphs": 4}
    assert sorted(os.listdir(tmp_path / "a")) == ["step_0000000005",
                                                  "step_0000000010"]
    resumed = _cli(tmp_path / "a", 14, "--resume")
    assert resumed["start_step"] == 10
    whole = _cli(tmp_path / "b", 14)
    assert first["losses"] == whole["losses"][:12]
    assert resumed["losses"] == whole["losses"][10:]
    assert np.isfinite(whole["losses"]).all()
    for name, p in whole["trainer"].params.items():
        assert torch.equal(resumed["trainer"].params[name], p), name
    assert signal.getsignal(signal.SIGTERM) is handler


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mace_checkpoints_are_the_same_bytes_both_ways(tmp_path, dtype):
    """MACE's (params, AdamWState) written by the port and by the
    reference: the same files, byte for byte; each restores the other's."""
    jcfg = jconfigs.get_arch("mace").make_reduced()
    tcfg = tconfigs.get_arch("mace").make_reduced()
    if dtype == "bfloat16":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    params = jmace.init_params(jcfg, jax.random.PRNGKey(6))
    rng = np.random.default_rng(6)
    mu = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
        a.shape).astype(np.float32)), params)
    nu = jax.tree.map(lambda a: jnp.abs(a) * 1e-3, mu)
    jtree = (params, JaxAdamWState(step=jnp.int32(7), mu=mu, nu=nu))
    trainer = ttrain.Trainer(convert.mace_from_arrays(
        tcfg, _np(params), device="cpu"), None)
    trainer.opt_state = convert.adamw_state_from_arrays(
        (np.int32(7), _np(mu), _np(nu)), device="cpu")
    dj = JaxCheckpointManager(str(tmp_path / "jax")).save(7, jtree)
    dt = CheckpointManager(str(tmp_path / "port")).save(
        7, trainer.state_tree())
    files = sorted(os.listdir(dj))
    assert files == sorted(os.listdir(dt))
    for f in files:
        if f == "manifest.json":
            continue
        with open(os.path.join(dj, f), "rb") as a, \
                open(os.path.join(dt, f), "rb") as b:
            assert a.read() == b.read(), f
    # the port restores the reference's files, the reference the port's
    step, tree = CheckpointManager(str(tmp_path / "jax")).restore(
        like=trainer.state_tree())
    assert step == 7
    for name, p in flat_state(tree[0]).items():
        assert p.dtype == tcfg.dtype
        assert torch.equal(p, trainer.params[name]), name
    step, (p_back, st_back) = JaxCheckpointManager(
        str(tmp_path / "port")).restore(like=jtree)
    assert step == 7 and int(st_back.step) == 7
    for a, b in zip(jax.tree.leaves(p_back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mace_config_cells_and_input_specs_match_the_reference():
    """The published and reduced configs field for field (the dtype as
    its torch counterpart), the GNN cells, ``pad_edges`` and every cell's
    input specs, static entries included."""
    jspec, tspec = jconfigs.get_arch("mace"), tconfigs.get_arch("mace")
    assert (tspec.family, tspec.source) == (jspec.family, jspec.source)
    dtypes = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    for make in ("make_config", "make_reduced"):
        jcfg, tcfg = getattr(jspec, make)(), getattr(tspec, make)()
        for f in dataclasses.fields(jcfg):
            want = getattr(jcfg, f.name)
            want = dtypes[want] if f.name == "dtype" else want
            assert getattr(tcfg, f.name) == want, f.name
        assert tcfg.param_count() == jcfg.param_count()
    from repro.configs import mace as jmace_cfg
    from repro_torch.configs import mace as tmace_cfg
    assert tmace_cfg.for_shape(tspec.make_config(), 602).d_feat == \
        jmace_cfg.for_shape(jspec.make_config(), 602).d_feat == 602
    assert [(c.shape, c.kind, c.dims, c.skip) for c in tspec.cells] == \
        [(c.shape, c.kind, c.dims, c.skip) for c in jspec.cells]
    from repro.configs.base import pad_edges as jpad
    from repro_torch.configs.base import pad_edges as tpad
    for e in (0, 1, 511, 512, 10556, 61859140):
        assert tpad(e) == jpad(e) and tpad(e, 64) == jpad(e, 64)
    for jcell, tcell in zip(jspec.cells, tspec.cells):
        want = jconfigs.input_specs(jspec, jspec.make_config(), jcell)
        got = tconfigs.input_specs(tspec, tspec.make_config(), tcell)
        assert got["static"] == want["static"]
        assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in got["batch"].items()} == {
            k: (tuple(v.shape), str(v.dtype))
            for k, v in want["batch"].items()}


_CELLS = [(arch, cell.shape) for arch in jconfigs.list_archs()
          for cell in jconfigs.get_arch(arch).cells]


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch,shape", _CELLS)
def test_model_flops_equal_the_references(arch, shape, reduced):
    """``estimate(arch, shape, cfg)`` is the reference's
    ``estimate(build_plan(arch, shape))``, key for key (a GNN config bound
    to the cell's feature width, its parameters counted from the port's
    model shapes)."""
    want = jflops.estimate(build_plan(arch, shape, reduced=reduced))
    spec = tconfigs.get_arch(arch)
    cfg = spec.make_reduced() if reduced else spec.make_config()
    assert tflops.estimate(arch, shape, cfg) == want
