"""The port's LM prefill and decode plans on a (data, model) mesh against
the JAX package's plans, on the CPU.

``launch.steps.build_plan(arch, "prefill_32k" | "decode_32k" |
"long_500k")``'s fn runs on CPU meshes of logical shards (1 x 2, 2 x 2,
1 x 4) and is held to the reference plan's fn under ``jax.jit`` on a
1 x 1 host mesh, on one set of weights (the port's ``init_params``,
passed to both) and numpy tokens, at reduced width and small B and S;
each reference function is compiled once. gemma2-2b covers the rolled
ring buffer (a 24-token prompt past its 16-token window) and both
softcaps; granite-8b (2 KV heads) on 1 x 4 the shards that hold copies
of one KV head; qwen2-moe-a2.7b and granite-moe-3b-a800m the MoE FFN on
1 x 2 and 2 x 2, where a decode step's MoE group (the batch's 16 tokens)
spans both data replicas: the second replica's tokens follow the slots
the first claimed (``moe.moe_ffn_sharded(carry=)``), and the capacity
binds (some assignments drop, counted by ``moe.recording``). A decode step
starts from the reference's ``prefill(pad_to=)`` cache laid out by the
plan's ``in_specs``, at cache lengths whose slots fall in every shard's
block of the global and the ring caches, wrap the ring and reach (and
pass) the last slot.

Tolerances (``tests/test_torch_lm.py``'s for prefill and decode): the
logits rtol 1e-5 / atol 1e-5 (they reach ~30 under gemma's softcap);
every cache leaf rtol 1e-5 / atol 1e-6; a decode step's written slots
rtol 1e-5 / atol 1e-6 and every other slot the input's bits. The split
softmax sums in another order than the reference's one softmax, so no
logit is held to its bits.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint.checkpoint import flat_state, nest_state  # noqa: E402,E501
from repro_torch.distributed import partition  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402

MOE_ARCHS = ("qwen2-moe-a2.7b", "granite-moe-3b-a800m")
LM_ARCHS = ["gemma2-2b", "qwen1.5-0.5b", "granite-8b", *MOE_ARCHS]
CELLS = ["prefill_32k", "decode_32k", "long_500k"]
MESHES = [(1, 2), (2, 2), (1, 4)]
SERVE_CASES = ([(a, m) for a in ("gemma2-2b", "granite-8b") for m in MESHES]
               + [(a, m) for a in MOE_ARCHS for m in ((1, 2), (2, 2))])
LOGITS = dict(rtol=1e-5, atol=1e-5)
CACHE = dict(rtol=1e-5, atol=1e-6)
#: prompt rows and length (past gemma's 16-token window), the global
#: caches' length after ``prefill(pad_to=)``, and the decode steps' cache
#: lengths: slots in the global cache's blocks of 2 and 4 shards past the
#: prompt (24, 35, 63), the ring's blocks of 2 and 4 (slots 8, 3, 15, 6),
#: the last global slot (63) and past it (70: written at 63)
B, S, PAD = 4, 24, 64
CACHE_LENS = (24, 35, 63, 70)
#: the MoE architectures' groups are 64 tokens: a prompt row fills one; a
#: decode step's group is the batch's 16 tokens, whose 64 assignments
#: exceed the 8 slots of some of the 8 experts (capacity(16, 4, 16, 1.25))
MOE_B, MOE_S = 16, 64


@pytest.fixture(autouse=True)
def _one_thread():
    """The shards here are small: one intra-op thread runs them faster,
    and keeps the workers of a parallel test run from oversubscribing the
    cores."""
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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _mesh(shape):
    return make_host_mesh(*shape, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _whole(tree):
    """A nested dict of ShardedTensors gathered whole (numpy)."""
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    return tree.gather().numpy()


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The port's reduced weights from one seed (``init_params``), by
    name, and the same leaves as the reference's numpy pytree."""
    cfg = tconfigs.get_arch(arch).make_reduced()
    model = ttfm.init_params(cfg, generator=torch.Generator().manual_seed(3))
    whole = {n: p.detach() for n, p in model.named_parameters()}
    return whole, nest_state({n: t.numpy() for n, t in whole.items()})


def _prompt(arch, seed=5):
    b, s = (MOE_B, MOE_S) if arch in MOE_ARCHS else (B, S)
    cfg = tconfigs.get_arch(arch).make_reduced()
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jitted(arch, what):
    """The reference's jitted functions, each compiled once: a cell's plan
    ``fn``, or ``"pad"``: ``prefill(pad_to=PAD)``."""
    if what == "pad":
        jcfg = jconfigs.get_arch(arch).make_reduced()
        return jax.jit(lambda p, t: jtfm.prefill(jcfg, p, t, pad_to=PAD))
    return jax.jit(jsteps.build_plan(arch, what, reduced=True).fn)


def _jparams(arch):
    return jax.tree.map(jnp.asarray, _weights(arch)[1])


@functools.lru_cache(maxsize=None)
def _reference_prefill(arch):
    """The reference prefill plan's (logits, cache) on the prompt."""
    with jmesh.make_host_mesh(1, 1):
        logits, cache = _jitted(arch, "prefill_32k")(
            _jparams(arch), jnp.asarray(_prompt(arch)))
    return np.asarray(logits), _np(cache)


@functools.lru_cache(maxsize=None)
def _reference_decode(arch, cell, rows):
    """From the reference's ``prefill(pad_to=PAD)`` cache of the prompt,
    its first ``rows`` rows (each row's cache its own): that cache, the
    token, and the reference decode plan's (logits, cache) at each of
    CACHE_LENS."""
    params = _jparams(arch)
    toks = jnp.asarray(_prompt(arch))
    _, cache = _jitted(arch, "pad")(params, toks)
    cache = jax.tree.map(lambda a: a[:, :rows], cache)
    token = toks[:rows, 3:4]
    out = {}
    with jmesh.make_host_mesh(1, 1):
        for n in CACHE_LENS:
            lg, c = _jitted(arch, cell)(params, cache, token, jnp.int32(n))
            out[n] = (np.asarray(lg), _np(c))
    return _np(cache), np.asarray(token), out


def _placed_params(plan, arch, mesh):
    return tsteps.place_args(plan, mesh, _weights(arch)[0])


def _slots(cfg, slen, window, n):
    return n % slen if window else min(n, slen - 1)


# -- the plans ---------------------------------------------------------------------


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("cell", CELLS)
def test_plan_has_the_reference_plans_specs(arch, cell):
    """Meta ``args`` of the reference plan's shapes and dtypes, its
    in and out specs leaf for leaf, and its ``skip``."""
    jplan = jsteps.build_plan(arch, cell, reduced=True)
    tplan = tsteps.build_plan(arch, cell, reduced=True)
    assert (tplan.kind, tplan.skip) == (jplan.kind, jplan.skip)

    def specs(tree):
        return [P(*s) for s in jax.tree.leaves(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]

    def flat(tree):
        return (flat_state(tree) if isinstance(tree, dict)
                else {"": tree})

    for j_spec, t_spec in zip(jplan.in_specs[1:], tplan.in_specs[1:]):
        assert specs(j_spec) == list(flat(t_spec).values())
    assert specs(jplan.out_specs) == [tplan.out_specs[0], *flat(
        tplan.out_specs[1]).values()]
    for j_arg, t_arg in zip(jplan.args[1:], tplan.args[1:]):
        j_leaves = jax.tree.leaves(j_arg)
        t_leaves = list(flat(t_arg).values())
        assert [(tuple(a.shape), str(a.dtype)) for a in j_leaves] == [
            (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in t_leaves]
        assert all(t.device.type == "meta" for t in t_leaves)
    for name, meta in tplan.args[0].items():
        assert meta.device.type == "meta", name
        assert isinstance(tplan.in_specs[0][name], P), name


# -- prefill --------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", SERVE_CASES)
def test_prefill_plan_matches_the_reference_plan(arch, shape):
    """Logits and every cache leaf, each laid out by the plan's out
    specs (the sequence over ``model``)."""
    want_logits, want_cache = _reference_prefill(arch)
    plan = tsteps.build_plan(arch, "prefill_32k", reduced=True)
    mesh = _mesh(shape)
    params = _placed_params(plan, arch, mesh)
    (tokens,) = tsteps.place_inputs(plan, mesh, _t(_prompt(arch)))
    logits, cache = plan.fn(params, tokens)
    assert logits.spec == plan.out_specs[0]
    np.testing.assert_allclose(logits.gather().numpy(), want_logits,
                               **LOGITS)
    for name, want in flat_state(want_cache).items():
        got = flat_state(cache)[name]
        assert got.spec == flat_state(plan.out_specs[1])[name]
        assert tuple(got.shards[0].shape[1:3]) == (
            want.shape[1] // shape[0], want.shape[2] // shape[1])
        np.testing.assert_allclose(got.gather().numpy(), want, **CACHE,
                                   err_msg=name)


# -- decode ------------------------------------------------------------------------------


def _check_decode(arch, cell, shape, rows):
    """The port's decode plan from the reference's padded prefill cache,
    one step at each of CACHE_LENS, against the reference plan's step."""
    cache0, token, want = _reference_decode(arch, cell, rows)
    plan = tsteps.build_plan(arch, cell, reduced=True)
    cfg = plan.cfg
    mesh = _mesh(shape)
    params = _placed_params(plan, arch, mesh)
    carried = arch in MOE_ARCHS and shape[0] > 1
    if carried:  # the unsharded decode drops the same assignments
        alone = convert.transformer_from_arrays(cfg, _weights(arch)[1],
                                                device="cpu")
    dropped = 0
    for n in CACHE_LENS:
        whole = jax.tree.map(_t, cache0)
        cache, tok, length = tsteps.place_inputs(
            plan, mesh, whole, _t(token), torch.tensor(n, dtype=torch.int32))
        with tmoe.recording() as rec:
            logits, cache = plan.fn(params, cache, tok, length)
        if carried:
            # each layer: the second replica takes the first's counts,
            # one a model shard; the group's capacity binds
            assert rec.handoffs == cfg.n_layers * shape[1] * (shape[0] - 1)
            assert rec.assignments == rows * cfg.top_k * cfg.n_layers
            with tmoe.recording() as one:
                ttfm.decode_step(cfg, alone, jax.tree.map(_t, cache0),
                                 _t(token), n)
            assert (one.handoffs, one.assignments, one.dropped) == (
                0, rec.assignments, rec.dropped)
            dropped += rec.dropped
        assert logits.spec == plan.out_specs[0]
        want_logits, want_cache = want[n]
        np.testing.assert_allclose(logits.gather().numpy(), want_logits,
                                   **LOGITS, err_msg=f"cache_len {n}")
        got = _whole(cache)
        for p, window in enumerate(cfg.layer_pattern):
            for kv in ("k", "v"):
                g, w0 = got[f"pos{p}"][kv], cache0[f"pos{p}"][kv]
                w1 = want_cache[f"pos{p}"][kv]
                slot = _slots(cfg, g.shape[2], window, n)
                np.testing.assert_allclose(
                    g[:, :, slot], w1[:, :, slot], **CACHE,
                    err_msg=f"pos{p}.{kv} slot {slot} at cache_len {n}")
                rest = np.delete(np.arange(g.shape[2]), slot)
                np.testing.assert_array_equal(g[:, :, rest], w0[:, :, rest])
    if carried:
        assert dropped > 0


@pytest.mark.parametrize("arch,shape", SERVE_CASES)
def test_decode_plan_matches_the_reference_plan(arch, shape):
    """decode_32k's plan: the batch over ``data``, the sequence over
    ``model``; the slot's owner alone writes it."""
    _check_decode(arch, "decode_32k", shape, _prompt(arch).shape[0])


@pytest.mark.parametrize("arch", ["gemma2-2b"])
def test_long_500k_plan_on_the_whole_mesh(arch):
    """long_500k's layout on 2 x 2: one row, the token replicated and the
    sequence over ("data", "model"), so the softmax spans all four
    positions, both data replicas' included."""
    plan = tsteps.build_plan(arch, "long_500k", reduced=True)
    assert plan.in_specs[1]["pos0"]["k"] == P(None, None, ("data", "model"),
                                              None, None)
    _check_decode(arch, "long_500k", (2, 2), 1)


def test_prefill_feeds_the_decode_plan():
    """The port's sharded prefill (padded) feeds its decode plan
    directly, and a rerun gives the same bits: gemma on 2 x 2 against the
    reference's prefill and decode steps over the continuation."""
    arch, shape = "gemma2-2b", (2, 2)
    jp = _jparams(arch)
    toks = _prompt(arch, seed=9)
    cont = np.random.default_rng(10).integers(
        0, tconfigs.get_arch(arch).make_reduced().vocab_size,
        (B, 6)).astype(np.int32)
    want_lg, jcache = _jitted(arch, "pad")(jp, jnp.asarray(toks))
    wants = []
    with jmesh.make_host_mesh(1, 1):
        for j in range(cont.shape[1]):
            lg, jcache = _jitted(arch, "decode_32k")(
                jp, jcache, jnp.asarray(cont[:, j:j + 1]), jnp.int32(S + j))
            wants.append(np.asarray(lg))

    plan = tsteps.build_plan(arch, "decode_32k", reduced=True)
    mesh = _mesh(shape)
    runs = []
    for _ in range(2):
        placed = _placed_params(plan, arch, mesh)
        model = ttfm.ShardedTransformer(plan.cfg, mesh, placed)
        lg, cache = ttfm.sharded_prefill(plan.cfg, model, _t(toks),
                                         pad_to=PAD)
        np.testing.assert_allclose(lg.gather().numpy(), np.asarray(want_lg),
                                   **LOGITS)
        assert cache["pos1"]["k"].spec == plan.in_specs[1]["pos1"]["k"]
        got = []
        for j in range(cont.shape[1]):
            lg, cache = plan.fn(placed, cache, _t(cont[:, j:j + 1]), S + j)
            got.append(lg.gather().numpy())
            np.testing.assert_allclose(got[-1], wants[j], **LOGITS,
                                       err_msg=f"step {j}")
        runs.append((got, _whole(cache)))
    for a, b in zip(runs[0][0], runs[1][0]):
        np.testing.assert_array_equal(a, b)
    for name, a in flat_state(runs[0][1]).items():
        np.testing.assert_array_equal(a, flat_state(runs[1][1])[name])


# -- the collective and the refusals ----------------------------------------------------


def test_all_to_all_relays_blocks_in_a_fixed_order():
    """Head-sharded to sequence-sharded: part m takes block m of every
    source's sequence, the heads in source order; copies of a head are
    taken from their first holder alone; with no split every part takes
    the sources whole."""
    gen = torch.Generator().manual_seed(0)
    whole = torch.randn((2, 8, 4, 3), generator=gen)
    parts = list(whole.chunk(4, 2))
    out = partition.all_to_all(parts, 1, 2)
    for m, o in enumerate(out):
        assert torch.equal(o, whole[:, 2 * m:2 * m + 2])
    two = torch.randn((2, 8, 2, 3), generator=gen)
    copies = [two[:, :, :1], two[:, :, :1] + 1, two[:, :, 1:], two[:, :, 1:]]
    out = partition.all_to_all(copies, 1, 2, sources=[0, 2])
    for m, o in enumerate(out):
        assert torch.equal(o, two[:, 2 * m:2 * m + 2])
    for o in partition.all_to_all(copies, None, 2, sources=[0, 2]):
        assert torch.equal(o, two)
    with pytest.raises(ValueError, match="does not split into 4 blocks"):
        partition.all_to_all([whole[:, :6]] * 4, 1, 2)


def test_ragged_cache_lengths_raise_naming_the_dimension():
    """A prompt whose global cache length does not split over the model
    shards, and a decode cache whose sequence does not split over the
    500k layout's four positions, raise naming the dimension (the
    reference pads; the port refuses)."""
    arch = "gemma2-2b"
    plan = tsteps.build_plan(arch, "prefill_32k", reduced=True)
    mesh = _mesh((1, 4))
    params = _placed_params(plan, arch, mesh)
    with pytest.raises(ValueError, match=r"dimension 2 \(sequence\) of the "
                                         r"pos1 cache .*\(30\) does not "
                                         r"split into 4 shards"):
        plan.fn(params, _t(np.random.default_rng(1).integers(
            0, plan.cfg.vocab_size, (B, 30)).astype(np.int32)))
    cfg = plan.cfg
    model = ttfm.ShardedTransformer(cfg, mesh, params)
    with pytest.raises(ValueError, match=r"dimension 2 \(sequence\)"):
        ttfm.sharded_prefill(cfg, model, _t(_prompt(arch)), pad_to=66)
    spec = P(None, None, ("data", "model"), None, None)
    mesh = _mesh((2, 2))
    model = ttfm.ShardedTransformer(cfg, mesh, _placed_params(plan, arch,
                                                              mesh))
    shape = (cfg.n_groups, 1, 30, cfg.n_kv_heads, cfg.head_dim)
    ragged = partition.ShardedTensor(mesh, spec, shape, cfg.dtype,
                                     [torch.zeros(shape)] * 4)
    ring = partition.place(torch.zeros(shape[:2] + (16,) + shape[3:]), spec,
                           mesh)
    cache = {"pos0": {"k": ring, "v": ring},
             "pos1": {"k": ragged, "v": ragged}}
    with pytest.raises(ValueError, match=r"dimension 2 \(sequence\) of the "
                                         r"pos1.k cache"):
        ttfm.sharded_decode_step(cfg, model, cache, torch.zeros(
            (1, 1), dtype=torch.int32), 3)
