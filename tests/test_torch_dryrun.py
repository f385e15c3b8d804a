"""The dry-run (``repro_torch.launch.dryrun``) and what it needs, against
the JAX package on the CPU.

* ``configs.all_cells`` is the reference's grid, in its order;
* every cell on both production meshes: each argument leaf's shard shape
  under the port's plan is the reference plan's
  (``NamedSharding(AbstractMesh(...), spec).shard_shape``; no compile),
  so ``argument_bytes`` is the reference's; model FLOPs equal
  ``repro.launch.model_flops.estimate``;
* the reduced cells of ``tests/test_lowering.py::CELLS`` on a (2, 2, 2)
  ("pod", "data", "model") mesh: the fake trace is ``ok`` (or the
  reference's skip), its FLOPs and collectives equal a real run of the
  same plan on a logical (2, 2, 2) CPU mesh exactly, and the real run
  gives the single device's results (loss, gradients through the
  moments, logits, top 100);
* the head repair (gemma2-reduced on 1 x 8, granite-moe-reduced on
  1 x 4) against the reference's loss and logits; an MoE decode whose
  group spans data replicas against the single device;
* the static-size row-gather backward and segment sum: the same bits as
  the forms they replaced;
* the retrieval plans lay their candidates P(dp, None);
* the extrapolation of an LM's layer groups equals a whole trace.

The cells run at small sizes: every mesh here is a few logical CPU
shards or placeholder positions.
"""
import dataclasses
import functools
import math
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import model_flops as jflops  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.distributed import partition  # noqa: E402
from repro_torch.distributed.mesh import Mesh, make_mesh  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import model_flops as tflops  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.optim import AdamWState  # noqa: E402

ALL = jconfigs.all_cells()
MESHES = ("pod", "multipod")
#: tests/test_lowering.py::CELLS
LOWERING = [("qwen1.5-0.5b", "train_4k"), ("gemma2-2b", "long_500k"),
            ("qwen2-moe-a2.7b", "decode_32k"), ("mace", "molecule"),
            ("dlrm-rm2", "train_batch"), ("xdeepfm", "retrieval_cand"),
            ("granite-8b", "long_500k")]
#: the cells' sizes for runs on the CPU (``build_plan(dims=)``: shapes as
#: the cells', scale cut)
SMALL = {"train_4k": {"seq_len": 32, "global_batch": 8},
         "decode_32k": {"seq_len": 32, "global_batch": 8},
         "long_500k": {"seq_len": 64, "global_batch": 1},
         "train_batch": {"batch": 32},
         "retrieval_cand": {"batch": 1, "n_candidates": 400},
         "molecule": {"n_nodes": 32, "n_edges": 64, "n_graphs": 4}}
STEP = dict(rtol=1e-4, atol=1e-6)
FWD = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _x32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _placeholders(shape, axes) -> Mesh:
    devices = np.empty(math.prod(shape), dtype=object)
    devices[:] = [torch.device("meta")] * devices.size
    return Mesh(devices.reshape(shape), axes)


POD3 = ((2, 2, 2), ("pod", "data", "model"))


def test_all_cells_are_the_references():
    assert tconfigs.all_cells() == ALL
    assert len(ALL) == 40
    assert sum(bool(tconfigs.get_arch(a).cell(s).skip) for a, s in ALL) == 4


# -- (i), (ii): every cell's argument shards and model FLOPs ------------------------


def _key(path) -> str:
    out = []
    for k in path:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                out.append(str(getattr(k, attr)))
                break
    return ".".join(out)


def _reference_shards(jplan, multi_pod: bool) -> dict:
    from jax.sharding import PartitionSpec as JP

    shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))
    mesh = AbstractMesh(shape, axes)
    leaves, _ = jax.tree_util.tree_flatten_with_path(jplan.args)
    specs = jax.tree_util.tree_leaves(jplan.in_specs,
                                      is_leaf=lambda x: isinstance(x, JP))
    return {_key(path): (tuple(leaf.shape), str(leaf.dtype).replace(
        "bfloat16", "bf16"), NamedSharding(mesh, spec).shard_shape(
        leaf.shape)) for (path, leaf), spec in zip(leaves, specs)}


def _port_shards(plan, mesh) -> dict:
    out = {}

    def walk(tree, spec, name):
        if isinstance(tree, AdamWState):
            for f in ("step", "mu", "nu"):
                walk(getattr(tree, f), getattr(spec, f), f"{name}.{f}")
        elif isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, spec[k], f"{name}.{k}")
        else:
            out[name] = (tuple(tree.shape), str(tree.dtype).replace(
                "torch.", "").replace("bfloat16", "bf16"),
                dryrun._shard_shape(tree.shape, spec, mesh, 0))

    for i, (a, s) in enumerate(zip(plan.args, plan.in_specs)):
        walk(a, s, str(i))
    return out


@functools.lru_cache(maxsize=None)
def _reference_plan(arch, shape, multi_pod=False):
    return jsteps.build_plan(arch, shape, multi_pod=multi_pod)


@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("arch,shape", ALL)
def test_argument_shards_are_the_reference_plans(arch, shape, mesh_kind):
    """Every argument leaf: the reference plan's shape, dtype and shard
    shape on the production mesh, so argument_bytes is the reference's
    (the sum of its shards' bytes)."""
    multi_pod = mesh_kind == "multipod"
    jplan = _reference_plan(arch, shape, multi_pod)
    plan = tsteps.build_plan(arch, shape, multi_pod=multi_pod)
    assert (plan.kind, plan.skip) == (jplan.kind, jplan.skip)
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    want = _reference_shards(jplan, multi_pod)
    got = _port_shards(plan, mesh)
    assert got == want
    nbytes = sum(math.prod(s) * np.dtype(jnp.dtype(
        d.replace("bf16", "bfloat16"))).itemsize for _, d, s in want.values())
    assert dryrun.argument_bytes(plan, mesh) == nbytes


@pytest.mark.parametrize("arch,shape", ALL)
def test_model_flops_are_the_references(arch, shape):
    jplan = _reference_plan(arch, shape)
    plan = tsteps.build_plan(arch, shape)
    assert tflops.estimate(arch, shape, plan.cfg) == jflops.estimate(jplan)


# -- (vi): the retrieval plans' candidates ------------------------------------------


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("mode", ["dense", "zen"])
def test_retrieval_candidates_lie_over_the_data_axes(multi_pod, mode):
    dp = ("pod", "data") if multi_pod else "data"
    plan = tsteps.build_plan("dlrm-rm2", "retrieval_cand",
                             multi_pod=multi_pod,
                             overrides={"retrieval_mode": mode})
    spec = plan.in_specs[2] if mode == "dense" else plan.in_specs[2]["coords"]
    assert spec == P(dp, None)
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    rows = plan.args[2].shape[0] if mode == "dense" \
        else plan.args[2]["coords"].shape[0]
    assert dryrun._shard_shape((rows, 1), spec, mesh, 0)[0] == rows // (
        32 if multi_pod else 16)


# -- the production mesh ----------------------------------------------------------------


def test_production_mesh():
    for multi_pod, shape, axes in ((False, (16, 16), ("data", "model")),
                                   (True, (2, 16, 16),
                                    ("pod", "data", "model"))):
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        assert mesh.devices.shape == shape and mesh.axis_names == axes
        assert {d.type for d in mesh.devices.flat} == {"meta"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_production_mesh()
    elif torch.cuda.device_count() < 256:
        with pytest.raises(RuntimeError, match=r"needs 256 cards, found"):
            make_production_mesh()


# -- (iii), (iv): the reduced lowering cells on (2, 2, 2) ----------------------------


def _draw(meta, gen):
    shape = tuple(meta.shape)
    if meta.dtype in (torch.int32, torch.int64):
        return torch.randint(0, 4, shape, generator=gen, dtype=meta.dtype)
    if meta.dtype == torch.bool:
        return torch.ones(shape, dtype=torch.bool)
    return (torch.randn(shape, generator=gen) * 0.05).to(meta.dtype)


def _run(plan, mesh, seed=0):
    """The plan's fn on ``mesh`` (logical CPU shards) under the dry-run's
    counters, its arguments drawn from ``seed`` (the same values on any
    mesh) and laid out by its specs."""
    gen = torch.Generator().manual_seed(seed)
    params = {n: _draw(m, gen) for n, m in plan.args[0].items()}

    def draw(tree):
        if isinstance(tree, dict):
            return {k: draw(v) for k, v in tree.items()}
        return _draw(tree, gen)

    if plan.kind == "train":
        placed, ost = tsteps.place_args(plan, mesh, params)
        batch = {k: partition.place(v, plan.in_specs[2][k], mesh)
                 for k, v in draw(plan.args[2]).items()}
        args = (placed, ost, batch)
    else:
        args = (tsteps.place_args(plan, mesh, params),
                *tsteps.place_inputs(plan, mesh,
                                     *[draw(a) for a in plan.args[1:]]))
        if plan.kind == "decode":
            args = args[:-1] + (dryrun.decode_cache_len(plan),)
    return dryrun.trace(plan, mesh, fake=False, args=args, keep_output=True)


def _whole(x):
    return x.gather() if isinstance(x, partition.ShardedTensor) else x


@pytest.mark.parametrize("arch,shape", LOWERING)
def test_lowering_cells_trace_on_the_multipod_mesh(arch, shape):
    """The reduced plan built for the multi-pod mesh: its fake trace on
    (2, 2, 2) placeholder positions is ok (granite-8b's long_500k is the
    reference's skip); its FLOPs and collectives equal a real run on a
    (2, 2, 2) logical CPU mesh exactly; and that run gives the single
    device's results from the same arguments."""
    plan = tsteps.build_plan(arch, shape, reduced=True, multi_pod=True,
                             dims=SMALL.get(shape))
    if plan.skip:
        assert (arch, shape) == ("granite-8b", "long_500k")
        return
    fake = dryrun.trace(plan, _placeholders(*POD3))
    real = _run(plan, make_mesh(*POD3, device="cpu"))
    assert fake["flops"] == real["flops"] > 0
    assert fake["collectives"] == real["collectives"]
    assert fake["output_bytes"] == real["output_bytes"]
    # the single device: the same plan on a (1, 1, 1) mesh
    out = real["output"]
    out1 = _run(plan, make_mesh((1, 1, 1), POD3[1], device="cpu"))["output"]
    if plan.kind == "train":
        np.testing.assert_allclose(out[2]["loss"].item(),
                                   out1[2]["loss"].item(), rtol=1e-5)
        for name, m in out1[1].mu.items():  # (1 - b1) x the gradients
            np.testing.assert_allclose(out[1].mu[name].gather().numpy(),
                                       m.gather().numpy(), **STEP,
                                       err_msg=name)
    elif plan.kind == "retrieval":
        assert torch.equal(out["ids"], out1["ids"])
        np.testing.assert_allclose(out["scores"].numpy(),
                                   out1["scores"].numpy(), **FWD)
    else:
        np.testing.assert_allclose(_whole(out[0]).numpy(),
                                   _whole(out1[0]).numpy(), **FWD)


def test_extrapolated_groups_equal_a_whole_trace():
    """An LM of three layer groups (gemma2's groups of a local and a
    global layer): c(1) + 2 (c(2) - c(1)) from the one- and two-group
    traces is the whole trace's count."""
    mesh = _placeholders((1, 2), ("data", "model"))
    over = {"n_layers": 6, "n_microbatches": 1}
    kw = dict(overrides=over, reduced=True, dims=SMALL["decode_32k"])
    whole = dryrun.cell_costs("gemma2-2b", "decode_32k", False, mesh,
                              whole=True, **kw)
    ext = dryrun.cell_costs("gemma2-2b", "decode_32k", False, mesh, **kw)
    assert ext["corrected"]["groups"] == 3
    assert whole["corrected"] == {"method": "counted whole"}
    for k in ("flops", "collectives", "output_bytes"):
        assert ext[k] == whole[k], k


def test_extrapolated_microbatches_equal_a_whole_trace():
    """A train step of three layer groups and four microbatches: the
    counts from the (groups, microbatches) = (1, 2), (2, 2), (1, 3)
    traces are the whole trace's."""
    mesh = _placeholders((1, 2), ("data", "model"))
    kw = dict(overrides={"n_layers": 3, "n_microbatches": 4},
              dims={"seq_len": 8, "global_batch": 4}, reduced=True)
    whole = dryrun.cell_costs("qwen1.5-0.5b", "train_4k", False, mesh,
                              whole=True, **kw)
    ext = dryrun.cell_costs("qwen1.5-0.5b", "train_4k", False, mesh, **kw)
    assert (ext["corrected"]["groups"],
            ext["corrected"]["microbatches"]) == (3, 4)
    for k in ("flops", "collectives", "output_bytes"):
        assert ext[k] == whole[k], k


def test_collectives_report_to_the_recorder():
    """Each collective reports its receivers and the bytes they take in,
    under the reference's names, forward and backward; nothing outside a
    recording; the results are the same with it on."""
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    a, b = (torch.randn((3, 4), requires_grad=True) for _ in range(2))
    plain = partition.all_sum([a, b])
    with partition.recording() as rec:
        out = partition.all_sum([a, b])
        torch.autograd.grad(out, [a, b], [torch.ones(3, 4)] * 2)
        partition.all_gather([a, b], 1)
        partition.sum_scatter([a, b], 1)
        partition.all_to_all([a, b], 1, 0)
        partition.all_max([a, b])
        partition.sum_to([a, b], "cpu")
        partition.send(a, "cpu")
        partition.reduce_holders_(partition.place(torch.ones(4), P(), mesh))
    assert all(torch.equal(x, y) for x, y in zip(out, plain))
    assert rec == {
        "all-reduce": {"count": 4, "bytes": 4 * 48},
        "all-gather": {"count": 2, "bytes": 2 * 96},
        "reduce-scatter": {"count": 2, "bytes": 2 * 24},
        "all-to-all": {"count": 2, "bytes": 2 * 48},
        "all_max": {"count": 2, "bytes": 2 * 48},
        "sum_to": {"count": 1, "bytes": 48},
        "collective-permute": {"count": 1, "bytes": 48},
        "reduce_holders": {"count": 2, "bytes": 2 * 16}}
    with partition.recording() as again:
        pass
    partition.all_sum([a, b])
    assert again == {}


def test_all_to_all_carries_its_inverse_gradient():
    """The differentiable re-layout (every part its own source): its
    backward is the inverse re-layout, so a round trip's gradient is the
    cotangent itself."""
    parts = [torch.randn((2, 4, 3), requires_grad=True) for _ in range(2)]
    there = partition.all_to_all(parts, 1, 2)
    assert [tuple(t.shape) for t in there] == [(2, 2, 6)] * 2
    back = partition.all_to_all(there, 2, 1)
    for p, q in zip(parts, back):
        assert torch.equal(p, q)
    cot = [torch.randn((2, 4, 3)) for _ in range(2)]
    grads = torch.autograd.grad(back, parts, cot)
    for g, c in zip(grads, cot):
        assert torch.equal(g, c)


def test_flop_formulas_count_the_mixed_precision_products():
    """The card's bf16 products call ``mm.dtype`` / ``bmm.dtype`` (``a, b,
    out_dtype``), which the stock formulas misread: the dry-run's count
    them as the plain products."""
    from torch.utils.flop_counter import FlopCounterMode

    a = torch.empty((3, 4, 5), device="meta", dtype=torch.bfloat16)
    b = torch.empty((3, 5, 6), device="meta", dtype=torch.bfloat16)
    with FlopCounterMode(display=False, custom_mapping=dryrun.flop_formulas()[
            "custom"]) as counter:
        torch.bmm(a, b, out_dtype=torch.float32)
        torch.mm(a[0], b[0], out_dtype=torch.float32)
        torch.bmm(a, b)
    assert counter.get_total_flops() == 2 * (2 * 3 * 4 * 5 * 6) + 2 * 4 * 5 * 6


def test_run_cell_records_a_skip_and_the_reference_keys(tmp_path):
    rec = dryrun.run_cell("granite-8b", "long_500k", "multipod",
                          str(tmp_path))
    assert rec["status"] == "skipped" and rec["n_devices"] == 512
    assert (tmp_path / "granite-8b__long_500k__multipod.json").exists()


# -- (v): the head repair, the MoE decode, the static sizes -------------------------


def _reference_lm(arch, seed=7):
    """The reference's weights, tokens, logits and loss (one compile)."""
    jcfg = jconfigs.get_arch(arch).make_reduced()
    toks = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (4, 32)).astype(np.int32)

    @jax.jit
    def run(key, t):
        p = jtfm.init_params(jcfg, key)
        return (p, jtfm.forward(jcfg, p, t),
                jtfm.loss_fn(jcfg, p, {"tokens": t})[0])

    params, logits, loss = run(jax.random.PRNGKey(seed), toks)
    return (jax.tree.map(np.asarray, params), toks, np.asarray(logits),
            float(loss))


@pytest.mark.parametrize("arch,M", [("gemma2-2b", 8),
                                    ("granite-moe-3b-a800m", 4)])
def test_heads_that_do_not_split_match_the_reference(arch, M):
    """n_heads % M != 0 (4 heads on 8 shards, 6 on 4): attention runs
    re-laid out over the sequence, the leaves keep the reference's
    layout, and the loss and logits are the reference's."""
    cfg = tconfigs.get_arch(arch).make_reduced()
    assert cfg.n_heads % M and ttfm._column_attention(cfg, M)
    params, toks, logits_j, loss_j = _reference_lm(arch)
    model = convert.transformer_from_arrays(
        cfg, params, mesh=make_mesh((1, M), ("data", "model"), device="cpu"))
    for name, st in model.params.items():
        assert st.spec == ttfm.param_specs(cfg)[name]
    tokens = torch.from_numpy(toks)
    got = ttfm.sharded_logits(cfg, model, tokens)
    np.testing.assert_allclose(got[..., :cfg.vocab_size].numpy(),
                               logits_j[..., :cfg.vocab_size], **FWD)
    loss, _ = ttfm.sharded_loss_fn(cfg, model, {"tokens": tokens})
    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)


def test_moe_decode_groups_span_data_replicas():
    """qwen2-moe's decode on 4 x 1: each replica holds 2 of the batch's 8
    tokens, one MoE group (the prompt's 64 tokens a row fill whole
    groups); its tokens follow the slots the earlier replicas claimed
    (capacity binding: some assignments drop), and the logits are the
    single device's."""
    cfg = dataclasses.replace(
        tconfigs.get_arch("qwen2-moe-a2.7b").make_reduced(),
        capacity_factor=0.25)
    gen = torch.Generator().manual_seed(4)
    whole = ttfm.init_sharded(cfg, make_mesh((1, 1), ("data", "model"),
                                             device="cpu"), generator=gen)
    params = {n: st.gather() for n, st in whole.params.items()}
    tokens = torch.randint(0, cfg.vocab_size, (8, 64),
                           generator=torch.Generator().manual_seed(5))
    out = []
    for shape in ((1, 1), (4, 1)):
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        model = ttfm.ShardedTransformer(cfg, mesh, {
            n: partition.place(p, whole.params[n].spec, mesh)
            for n, p in params.items()})
        _, cache = ttfm.sharded_prefill(cfg, model, tokens, pad_to=72)
        logits, _ = ttfm.sharded_decode_step(cfg, model, cache,
                                             tokens[:, :1], 64)
        out.append(logits.gather())
    np.testing.assert_allclose(out[1].numpy(), out[0].numpy(), **FWD)


def _old_gather_backward(grad, ids, n_rows):
    out = grad.new_zeros((n_rows, grad.shape[-1]))
    flat = ids.reshape(-1)
    if flat.numel() == 0:
        return out
    order = torch.argsort(flat, stable=True)
    rows, counts = torch.unique_consecutive(flat[order], return_counts=True)
    out[rows] = torch.segment_reduce(grad.reshape(flat.numel(), -1)[order],
                                     "sum", lengths=counts)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_static_sizes_give_the_same_bits(dtype):
    """The gather's backward and ``segment_sum`` with their lengths from
    ``searchsorted`` (no host read) against the ``unique_consecutive`` /
    ``bincount`` forms they replaced: the same bits, repeated and absent
    rows and an empty shard included."""
    gen = torch.Generator().manual_seed(0)
    for n_ids, n_rows in ((200, 37), (0, 9), (50, 1000)):
        ids = torch.randint(0, n_rows, (n_ids,), generator=gen)
        grad = torch.randn((n_ids, 6), generator=gen).to(dtype)
        table = torch.zeros((n_rows, 6), dtype=dtype, requires_grad=True)
        (got,) = torch.autograd.grad(L.gather_rows(table, ids), table, grad)
        assert torch.equal(got, _old_gather_backward(grad, ids, n_rows))
        data = torch.randn((n_ids, 3, 2), generator=gen).to(dtype)
        want = torch.segment_reduce(
            data[torch.argsort(ids, stable=True)].reshape(n_ids, 6), "sum",
            lengths=torch.bincount(ids, minlength=n_rows)).view(n_rows, 3, 2)
        assert torch.equal(L.segment_sum(data, ids, n_rows), want)
