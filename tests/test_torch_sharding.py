"""The port's partition rules (``repro_torch.distributed.sharding``)
against the JAX package's, on the CPU.

Every leaf of every architecture in the registry, full and reduced: the
reference's specs come from ``jax.eval_shape`` of its ``init_params``,
the port's from a meta-device model (no storage). Leaf names are the
reference's pytree paths joined by ``.`` (the port's parameter names).
Then the optimizer-state specs, the input shardings of every cell kind,
the manifest's JSON form, and the trainer CLIs' checkpoint manifests: the
port's carry the same specs as the reference's, leaf for leaf, for one
architecture of each family. Tolerances: exact.
"""
import json
import os
import sys
from functools import partial

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import mace as jmace  # noqa: E402
from repro.models import recsys as jrecsys  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.distributed import sharding as tsharding  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import mace as tmace  # noqa: E402
from repro_torch.models import recsys as trecsys  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402

ARCHS = jconfigs.list_archs()
_JINIT = {"lm": jtfm.init_params, "gnn": jmace.init_params,
          "recsys": jrecsys.init_params}
_TMODEL = {"lm": lambda c: ttfm.Transformer(c, device="meta"),
           "gnn": lambda c: tmace.MACE(c, device="meta"),
           "recsys": lambda c: trecsys.RecsysModel(c, device="meta")}


def _name(path) -> str:
    return ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _jflat(tree) -> dict:
    """Leaf name -> the reference spec as a tuple."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {_name(path): tuple(sp) for path, sp in flat}


def _tflat(specs: dict) -> dict:
    return {n: tuple(sp) for n, sp in specs.items()}


def test_the_registry_is_the_same():
    assert ARCHS == tconfigs.list_archs()


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, reduced):
    jspec, tspec = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    jcfg = jspec.make_reduced() if reduced else jspec.make_config()
    tcfg = tspec.make_reduced() if reduced else tspec.make_config()
    shapes = jax.eval_shape(partial(_JINIT[jspec.family], jcfg),
                            jax.random.PRNGKey(0))
    want = _jflat(jsharding.param_specs(jspec.family, shapes))
    model = _TMODEL[tspec.family](tcfg)
    got = _tflat(tsharding.param_specs(tspec.family, model))
    assert got == want
    # the shapes the rules were matched against are the same leaves
    jshapes = {_name(p): tuple(x.shape) for p, x in
               jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
        jshapes
    # and the optimizer state inherits them; step replicated
    jo = jsharding.opt_state_specs(
        jsharding.param_specs(jspec.family, shapes))
    to = tsharding.opt_state_specs(tsharding.param_specs(tspec.family,
                                                         model))
    assert tuple(to.step) == tuple(jo.step) == ()
    assert _tflat(to.mu) == _jflat(jo.mu) and _tflat(to.nu) == _jflat(jo.nu)


def test_lm_rules_keep_first_match_order_and_rank_guard():
    """``layers/ws_gate_logit`` is replicated although ``layers/ws_gate``
    is a prefix of it; a rule longer than its leaf's rank falls through to
    the next match."""
    specs = tsharding.lm_param_specs({
        "layers.ws_gate_logit": (2, 1, 8, 1), "layers.ws_gate": (2, 1, 8, 4),
        "layers.wq": (8, 4), "embed": (16, 8), "layers.other": (3,)})
    assert specs["layers.ws_gate_logit"] == tsharding.P()
    assert specs["layers.ws_gate"] == tsharding.P(None, None, None, "model")
    jspecs = jsharding.lm_param_specs({
        "layers": {"wq": jax.ShapeDtypeStruct((8, 4), "float32")}})
    assert tuple(specs["layers.wq"]) == tuple(jspecs["layers"]["wq"]) == ()
    assert specs["layers.other"] == tsharding.P()


def _tree(x):
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    return tuple(x)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_input_shardings_equal_the_reference(multi_pod):
    for arch in ARCHS:
        spec = jconfigs.get_arch(arch)
        for cell in spec.cells:
            if spec.family == "lm":
                want = jsharding.lm_input_shardings(cell.kind, cell.shape,
                                                    multi_pod, None)
                got = tsharding.lm_input_shardings(cell.kind, cell.shape,
                                                   multi_pod, None)
            elif spec.family == "gnn":
                want = jsharding.gnn_input_shardings(multi_pod)
                got = tsharding.gnn_input_shardings(multi_pod)
            else:
                want = jsharding.recsys_input_shardings(cell.kind, multi_pod)
                got = tsharding.recsys_input_shardings(cell.kind, multi_pod)
            assert _tree(got) == _tree(want), (arch, cell.shape)
    assert tsharding.data_axes(multi_pod) == jsharding.data_axes(multi_pod)


@pytest.mark.parametrize("entries", [(), (None,), ("model", None),
                                     (None, None, "model", None, None),
                                     (("data", "model"), None),
                                     (None, None, ("pod", "data", "model"))])
def test_manifest_json_round_trips(entries):
    got = tsharding.spec_to_json(tsharding.P(*entries))
    assert got == jckpt._spec_to_json(JP(*entries))
    assert json.loads(json.dumps(got)) == got
    assert tsharding.spec_from_json(got) == tsharding.P(*entries)
    assert tuple(jckpt._spec_from_json(got)) == tuple(
        tsharding.spec_from_json(got))
    assert tsharding.spec_to_json(None) == jckpt._spec_to_json(None) == []


def _manifest(directory) -> dict:
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    with open(os.path.join(directory, steps[-1], "manifest.json")) as f:
        return {e["name"]: e["spec"] for e in json.load(f)["leaves"]}


def _reference_cli_save(arch, directory):
    """What the reference CLI saves for ``arch`` (``repro.launch.train``:
    ``(params, opt_state)`` with ``(pspecs, opt_state_specs(pspecs))``),
    written by its own ``CheckpointManager``. Its loop cannot run MACE
    (its jitted step traces the batch's ``n_graphs``, which MACE's segment
    sums need as a Python int), so the save is made here with its
    objects."""
    from repro.optim import AdamW as JAdamW

    spec = jconfigs.get_arch(arch)
    cfg = spec.make_reduced()
    params = _JINIT[spec.family](cfg, jax.random.PRNGKey(0))
    opt_state = JAdamW(learning_rate=3e-4).init(params)
    pspecs = jsharding.param_specs(spec.family,
                                   jax.eval_shape(lambda: params))
    jckpt.CheckpointManager(str(directory)).save(
        1, (params, opt_state), (pspecs, jsharding.opt_state_specs(pspecs)))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mace", "dlrm-rm2"])
def test_cli_manifests_carry_the_reference_rules(arch, tmp_path,
                                                 monkeypatch):
    """The port CLI's checkpoint (one reduced step, saved after it) holds
    the same leaves with the same specs as the reference CLI's."""
    common = ["--arch", arch, "--reduced", "--steps", "1", "--batch", "2",
              "--seq", "16", "--ckpt-every", "1"]
    if arch == "mace":
        _reference_cli_save(arch, tmp_path / "jax")
    else:
        monkeypatch.setattr(sys, "argv", ["train"] + common + [
            "--ckpt-dir", str(tmp_path / "jax")])
        jtrain.main()
    ttrain.main(common + ["--ckpt-dir", str(tmp_path / "port"), "--device",
                          "cpu"])
    want, got = _manifest(tmp_path / "jax"), _manifest(tmp_path / "port")
    assert got == want
    assert any(sp for sp in got.values())  # not every leaf replicated
