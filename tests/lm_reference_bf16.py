"""Reference runs for the port's bf16 LM tests, in a process of their own.

    python tests/lm_reference_bf16.py PARAMS.npz OUT.npz

jits the reference's prefill and decode (``repro.models.transformer``)
on bf16 smoke configs, with the parameter trees the test saved in
PARAMS.npz (``flatten``), and saves their outputs (as float32 values) for
``tests/test_torch_models.py``.  The process sets
``--xla_allow_excess_precision=false`` before JAX starts, so that each
bf16 op of the reference rounds where its code writes it, as it does
evaluated op by op (``jax.disable_jit()``, which gives the same numbers
and takes minutes).  With the flag at its default, XLA drops the
rounding of a bf16 op whose result is then converted to float32 (the
residual add before each ``rms_norm``); the jitted and the op-by-op
reference then differ by 0.27 in the gemma3-4b smoke logits (scale 7.1,
bf16) — a difference of XLA's fusion, not of the model.  float32 runs
do not depend on the flag and stay in the test's own process.

Also the inputs and the prefill-cache mapping the test shares.
"""
import os
import sys

import numpy as np

# (arch, B, T) of each bf16 run, and the seed of its tokens
KINDS = ("recurrentgemma-9b", "xlstm-350m", "dbrx-132b", "llama4-maverick-400b-a17b")
PREFILL = (("gemma3-4b", 2, 40), ("qwen2.5-32b", 2, 24), ("internvl2-2b", 2, 24)) + tuple(
    (arch, 2, 24) for arch in KINDS)
DECODE = ("gemma3-4b", 2, 24)  # bf16 caches, across the window-16 ring's wrap
DECODE_KINDS = tuple((arch, 2, 20) for arch in KINDS)  # bf16 caches and states
ARCHS = tuple(dict.fromkeys(a for a, _, _ in PREFILL + (DECODE,) + DECODE_KINDS))
ATTENTION = ("attn", "moe")  # the layer kinds that hold a KV cache
SEED = 0


def tokens(vocab: int, b: int, t: int, seed: int = SEED) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


def flatten(tree, prefix: str = "") -> dict:
    """A nested dict / list of arrays as {"a/b/0/c": array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten(flat: dict) -> dict:
    """The inverse of ``flatten`` for a parameter tree (``leftover`` is a
    list, everything else dicts)."""
    tree: dict = {"units": {}, "leftover": []}
    for key, arr in flat.items():
        parts = key.split("/")
        node = tree
        for part in parts[:-1]:
            if isinstance(node, list):
                part = int(part)
                while len(node) <= part:
                    node.append({})
                node = node[part]
            else:
                node = node.setdefault(part, [] if part == "leftover" else {})
        node[parts[-1]] = arr
    return tree


def per_layer_kv(caches, cfg) -> list:
    """The reference's prefill caches — a tuple over the pattern's
    attention positions of (k, v) stacked over units, then each attention
    leftover's (k, v) — as one (k, v) an attention layer in layer order
    (the port's layout).  Recurrent layers return no cache."""
    n_unit = len(cfg.pattern_unit)
    unit_pos = [p for p, kind in enumerate(cfg.pattern_unit) if kind in ATTENTION]
    stacks, left = (caches[0], iter(caches[1:])) if cfg.n_units else ((), iter(caches))
    out = []
    for i, kind in enumerate(cfg.layer_kinds):
        if kind not in ATTENTION:
            continue
        if i < cfg.n_units * n_unit:
            u, pos = divmod(i, n_unit)
            k, v = stacks[unit_pos.index(pos)]
            out.append((k[u], v[u]))
        else:
            out.append(next(left))
    return out


def main(params_path: str, out_path: str) -> None:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_allow_excess_precision=false").strip()
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config
    from repro.configs.base import ShapeConfig
    from repro.distributed.sharding import NULL_LAYOUT
    from repro.models import transformer as tfm
    from repro.models import zoo

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))

    with np.load(params_path) as z:
        flat = dict(z)
    trees = {arch: unflatten({k[len(arch) + 1:]: v for k, v in flat.items()
                              if k.startswith(arch + "/")})
             for arch in ARCHS}
    res = {}
    for arch, b, t in PREFILL:
        cfg = get_smoke_config(arch)
        params = trees[arch]
        if cfg.frontend == "vision_stub":
            batch = zoo.make_concrete_batch(cfg, ShapeConfig("prefill", t, b, "prefill"))
        else:
            batch = {"tokens": jnp.asarray(tokens(cfg.vocab_size, b, t))}
        logits, caches = jax.jit(
            lambda p, bt, c=cfg: tfm.forward_prefill(p, c, NULL_LAYOUT, bt))(params, batch)
        res[f"{arch}/prefill/logits"] = f32(logits)
        for i, (k, v) in enumerate(per_layer_kv(caches, cfg)):
            res[f"{arch}/prefill/k{i}"], res[f"{arch}/prefill/v{i}"] = f32(k), f32(v)

    for arch, b, t in (DECODE,) + DECODE_KINDS:
        cfg = get_smoke_config(arch)
        params = trees[arch]
        toks = tokens(cfg.vocab_size, b, t)
        caches = tfm.init_caches(cfg, b, t, jnp.bfloat16)
        step = jax.jit(lambda p, c, tok, pos, cfg=cfg: tfm.forward_decode(p, cfg, NULL_LAYOUT, tok,
                                                                         c, pos))
        steps = []
        for i in range(t):
            logits, caches = step(params, caches, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
            steps.append(f32(logits))
        res[f"{arch}/decode/logits"] = np.stack(steps)
        for i, c in enumerate(caches):
            for key, val in c.items():
                res[f"{arch}/decode/{key}{i}"] = np.asarray(val) if key == "pos" else f32(val)
    np.savez(out_path, **res)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
