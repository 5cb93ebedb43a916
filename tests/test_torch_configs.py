"""The port's model configs and token stream (``repro_torch.configs``,
``repro_torch.data.tokens``) against the reference's.

Every arch id answers in both packages with the same ``CONFIG`` and
``smoke_config()``, field by field, and the same derived counts
(``param_count``, ``active_param_count``, ``layer_kinds``,
``layer_windows``, units and leftovers) and benchmark shapes; the token
stream's batches are equal for two seeds and steps.  Pure Python and
numpy: no tolerance.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import tokens  # noqa: E402

DERIVED = ("param_count", "active_param_count")
PROPS = ("layer_kinds", "layer_windows", "n_units", "n_leftover")


def test_same_arch_ids():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_equals_reference(arch, smoke):
    get, jget = ((configs.get_smoke_config, jconfigs.get_smoke_config) if smoke
                 else (configs.get_config, jconfigs.get_config))
    cfg, ref = get(arch), jget(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    for name in DERIVED:
        assert getattr(cfg, name)() == getattr(ref, name)(), name
    for name in PROPS:
        assert getattr(cfg, name) == getattr(ref, name), name
    assert ([dataclasses.asdict(s) for s in configs.shapes_for(cfg)]
            == [dataclasses.asdict(s) for s in jconfigs.shapes_for(ref)])


def test_gemma3_4b_full_width_counts():
    """The smoke run's model: 34 layers, 5:1 local:global (window 1024),
    3,879,907,840 parameters."""
    cfg = configs.get_config("gemma3-4b")
    assert cfg.param_count() == 3_879_907_840
    assert cfg.layer_windows.count(None) == 5 and cfg.n_layers == 34


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 17)])
def test_batch_at_step_equals_reference(seed, step):
    kw = dict(vocab_size=512, seq_len=33, global_batch=3, seed=seed)
    got = tokens.batch_at_step(tokens.TokenStreamConfig(**kw), step)
    want = jtokens.batch_at_step(jtokens.TokenStreamConfig(**kw), step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    s = tokens.stream(tokens.TokenStreamConfig(**kw), start_step=step)
    first, batch = next(s)
    assert first == step and np.array_equal(batch["tokens"], want["tokens"])
