"""How far a bf16 decode drifts from its own forward, in the JAX package and
in the PyTorch port, on the CPU at gemma2-2b's published width and depth.

Both packages get the same bf16 weights (the port's ``init_params`` from
one seed, handed to the reference as its pytree) and the same tokens: a
prompt past the 4,096-token window (so the local layers' ring buffer is
rolled and wraps), then ``--steps`` decode steps. Each package's logits of
the prefill's last position and of every decode step are held to its own
forward at the same positions (max and mean |diff|, and how often the
argmax agrees), and the port's decode logits to the reference's. The
forward's logits are taken only at the compared positions (the
vocabulary product of the other positions is not needed), in both
packages alike.

Run from the repository root (~9 minutes and ~12 GB of host memory on 8
cores):

    PYTHONPATH=src python tools/c11_decode_spread.py --out c11.json

It prints one JSON object, and writes it to ``--out`` when given.
"""
import argparse
import json
import time

import numpy as np


def readings(got: np.ndarray, want: np.ndarray) -> dict:
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return {"max": float(diff.max()), "mean": float(diff.mean()),
            "argmax_equal": int((got.argmax(-1) == want.argmax(-1)).sum()),
            "of": int(got.shape[0] * got.shape[1]),
            "largest_logit": float(np.abs(want).max())}


def port_side(cfg, toks: np.ndarray, prompt: int, steps: int, seed: int):
    """The port's weights (as a numpy pytree of bf16 views), its forward's
    logits at the compared positions and its prefill -> decode logits."""
    import torch

    from repro_torch.checkpoint.checkpoint import nest_state
    from repro_torch.models import transformer

    total = prompt + steps
    model = transformer.init_params(
        cfg, generator=torch.Generator().manual_seed(seed))
    model.requires_grad_(False)
    tokens = torch.from_numpy(toks)
    t0 = time.perf_counter()
    with torch.no_grad():
        x = transformer._embed(cfg, model, tokens)
        x = transformer._final_hidden(
            cfg, model, x, transformer._positions(1, total, "cpu"),
            remat=False)
        fwd = transformer._lm_logits(cfg, model,
                                     x[:, prompt - 1:total - 1])
        del x
        lg, cache = transformer.prefill(cfg, model, tokens[:, :prompt],
                                        pad_to=total)
        dec = [lg]
        for j in range(steps - 1):
            n = prompt + j
            lg, cache = transformer.decode_step(cfg, model, cache,
                                                tokens[:, n:n + 1], n)
            dec.append(lg)
    seconds = time.perf_counter() - t0
    import ml_dtypes

    arrays = nest_state({
        n: p.detach().view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        for n, p in model.named_parameters()})
    return (model, arrays, fwd[0].numpy(), torch.stack(dec, 1)[0].numpy(),
            seconds)


def reference_side(jcfg, params, toks: np.ndarray, prompt: int, steps: int):
    """The reference's forward logits at the compared positions (its
    ``forward`` with the vocabulary product cut to them) and its prefill
    -> decode logits, each function jitted once."""
    import jax
    import jax.numpy as jnp

    from repro.models import layers as L
    from repro.models import transformer as jtfm

    total = prompt + steps

    @jax.jit
    def tail_logits(params, tokens):
        B, S = tokens.shape
        x = params["embed"][tokens].astype(jcfg.dtype)
        if jcfg.embed_scale:
            x = x * jnp.asarray(jcfg.d_model**0.5, jcfg.dtype)
        positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))

        def group_body(x, group_params):
            for pos in range(jcfg.pattern_len):
                p = jax.tree.map(lambda a: a[pos], group_params)
                x, _ = jtfm._one_layer(jcfg, p, x, positions,
                                       jcfg.layer_pattern[pos])
            return x, None

        x, _ = jtfm._scan_groups(jcfg, jtfm._remat(jcfg, group_body), x,
                                 params["layers"])
        x = L.rms_norm(x, params["final_norm"], jcfg.norm_eps,
                       plus_one=jcfg.norm_plus_one)
        return jtfm._lm_logits(jcfg, params, x[:, prompt - 1:total - 1])

    prefill = jax.jit(lambda p, t: jtfm.prefill(jcfg, p, t, pad_to=total))
    decode = jax.jit(lambda p, c, t, n: jtfm.decode_step(jcfg, p, c, t, n))
    t0 = time.perf_counter()
    tokens = jnp.asarray(toks)
    fwd = np.asarray(tail_logits(params, tokens))
    lg, cache = prefill(params, tokens[:, :prompt])
    dec = [np.asarray(lg)]
    for j in range(steps - 1):
        n = prompt + j
        lg, cache = decode(params, cache, tokens[:, n:n + 1], jnp.int32(n))
        dec.append(np.asarray(lg))
    return fwd[0], np.stack(dec, 1)[0], time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prompt", type=int, default=4_608)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (default: the published 26)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs

    cfg = tconfigs.get_arch("gemma2-2b").make_config()
    jcfg = jconfigs.get_arch("gemma2-2b").make_config()
    if args.layers is not None:
        import dataclasses
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
        jcfg = dataclasses.replace(jcfg, n_layers=args.layers)
    total = args.prompt + args.steps
    toks = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (1, total)).astype(np.int32)
    model, arrays, t_fwd, t_dec, t_s = port_side(cfg, toks, args.prompt,
                                                 args.steps, args.seed)
    params = jax.tree.map(jnp.asarray, arrays)
    del model, arrays
    j_fwd, j_dec, j_s = reference_side(jcfg, params, toks, args.prompt,
                                       args.steps)
    out = {
        "arch": "gemma2-2b", "n_layers": cfg.n_layers, "dtype": "bfloat16",
        "prompt": args.prompt, "steps": args.steps, "seed": args.seed,
        "reference_decode_vs_its_forward": readings(j_dec, j_fwd),
        "port_decode_vs_its_forward": readings(t_dec, t_fwd),
        "port_decode_vs_reference_decode": readings(t_dec, j_dec),
        "port_forward_vs_reference_forward": readings(t_fwd, j_fwd),
        "seconds": {"port": round(t_s, 1), "reference": round(j_s, 1)},
        "host": {"torch_threads": __import__("torch").get_num_threads(),
                 "jax": jax.__version__},
    }
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
