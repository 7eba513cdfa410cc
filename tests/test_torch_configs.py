"""repro_torch's configs, param specs and params bridge against ``repro``;
the port's import hygiene (no jax, nothing of repro)."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, leaving the cores to the other test
# workers (eight spinning OpenMP threads per worker oversubscribe them)
torch.set_num_threads(1)

from repro.configs import gpt_paper as jgpt  # noqa: E402
from repro.configs import llama3p2_1b as jllama  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.api import SessionError, session  # noqa: E402
from repro_torch.configs import gpt_paper as tgpt  # noqa: E402
from repro_torch.configs import llama3p2_1b as tllama  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

PKG = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _fields(obj):
    return dataclasses.asdict(obj)


def test_llama_configs_equal_reference_field_by_field():
    assert _fields(tllama.config()) == _fields(jllama.config())
    tcfg, trc = tllama.reduced()
    jcfg, jrc = jllama.reduced()
    assert _fields(tcfg) == _fields(jcfg)
    assert _fields(trc) == _fields(jrc)
    # the dataclasses themselves carry the same fields and defaults
    from repro.models import common as jc
    from repro_torch.models import common as tc
    for name in ("ModelConfig", "RunConfig", "ShapeConfig", "ParamSpec",
                 "MoECfg", "MLACfg", "MambaCfg", "XLSTMCfg", "EncDecCfg"):
        jf = [(f.name, f.default) for f in dataclasses.fields(
            getattr(jc, name))]
        tf = [(f.name, f.default) for f in dataclasses.fields(
            getattr(tc, name))]
        assert tf == jf, name
    one = tllama.one_card_run()
    assert (one.pp, one.vpp, one.microbatches, one.groups) == (1, 1, 1, 1)
    assert one.param_dtype == one.compute_dtype == "bfloat16"


def test_gpt_configs_equal_reference_field_by_field():
    """The paper's GPT models (Table 4): SIZES, ``config(size)`` for all
    three sizes and ``reduced()``; the one-card training run; gpt-1.5B's
    parameter count (22 layers of 63,710,208, an embedding and an untied
    head of 115,900,416 each, the final LayerNorm) and its head width,
    96."""
    assert tgpt.SIZES == jgpt.SIZES
    for size in jgpt.SIZES:
        assert _fields(tgpt.config(size)) == _fields(jgpt.config(size))
    tcfg, trc = tgpt.reduced()
    jcfg, jrc = jgpt.reduced()
    assert _fields(tcfg) == _fields(jcfg)
    assert _fields(trc) == _fields(jrc)
    cfg = tgpt.config()
    assert (cfg.head_dim, cfg.n_kv_heads, cfg.max_seq) == (96, 24, 1024)
    rc = tgpt.one_card_train_run()
    assert (rc.pp, rc.vpp, rc.microbatches, rc.unit, rc.schedule) == (
        1, 2, 4, 2, "zeropp")
    geo = tmodel.build_geometry(cfg, rc)
    seg = geo.segments[0]
    layer = sum(int(np.prod(s_.shape))
                for s_ in tmodel.stage_specs(cfg, seg).values()) // seg.k
    io_ = {n: int(np.prod(s_.shape)) for n, s_ in tmodel.io_specs(
        cfg).items()}
    assert layer == 63_710_208
    assert io_["embed.table"] == io_["head.w"] == 115_900_416
    # with the final LayerNorm's scale and bias
    assert layer * cfg.n_layers + sum(io_.values()) == 1_633_430_016
    assert session("gpt_paper", mode="train", reduced=False,
                   device="cpu").describe()["n_params"] == 1_633_430_016


@pytest.mark.parametrize("full,pp", [(True, 1), (False, 2)])
def test_gpt_param_specs_equal_reference(full, pp):
    """Stage and io specs of gpt (LayerNorm scale and bias, the GELU MLP's
    wi and wd, the untied head, the final norm's bias) name for name."""
    cfg = jgpt.config() if full else jgpt.reduced()[0]
    tcfg = tgpt.config() if full else tgpt.reduced()[0]
    jrc = dataclasses.replace(jgpt.reduced()[1], pp=pp)
    trc = dataclasses.replace(tgpt.reduced()[1], pp=pp)
    jgeo, tgeo = jmodel.build_geometry(cfg, jrc), tmodel.build_geometry(
        tcfg, trc)
    for js, ts in zip(jgeo.segments, tgeo.segments):
        assert _fields(ts) == _fields(js)
        jspec = {n: _fields(s) for n, s in jmodel.stage_specs(cfg, js).items()}
        tspec = {n: _fields(s)
                 for n, s in tmodel.stage_specs(tcfg, ts).items()}
        assert tspec == jspec
        assert {"L0.ln1.bias", "L0.ffn.wi", "L0.ffn.wd"} <= set(tspec)
    tio = {n: _fields(s) for n, s in tmodel.io_specs(tcfg).items()}
    assert tio == {n: _fields(s) for n, s in jmodel.io_specs(cfg).items()}
    assert {"final_norm.bias", "head.w"} <= set(tio)


@pytest.mark.parametrize("full,pp", [(False, 1), (False, 2), (True, 1)])
def test_param_specs_equal_reference(full, pp):
    cfg = jllama.config() if full else jllama.reduced()[0]
    tcfg = tllama.config() if full else tllama.reduced()[0]
    jrc = dataclasses.replace(jllama.reduced()[1], pp=pp)
    trc = dataclasses.replace(tllama.reduced()[1], pp=pp)
    jgeo, tgeo = jmodel.build_geometry(cfg, jrc), tmodel.build_geometry(
        tcfg, trc)
    assert tgeo.pp == jgeo.pp
    for js, ts in zip(jgeo.segments, tgeo.segments):
        assert _fields(ts) == _fields(js)
        assert tgeo.seg_stages(ts) == jgeo.seg_stages(js)
        jspec = {n: _fields(s) for n, s in jmodel.stage_specs(cfg, js).items()}
        tspec = {n: _fields(s)
                 for n, s in tmodel.stage_specs(tcfg, ts).items()}
        assert tspec == jspec
    assert {n: _fields(s) for n, s in tmodel.io_specs(tcfg).items()} == \
        {n: _fields(s) for n, s in jmodel.io_specs(cfg).items()}


def test_params_bridge_round_trips():
    cfg, rc = jllama.reduced()
    host = jax.tree.map(np.asarray, jmodel.init_all_params(
        cfg, rc, jax.random.PRNGKey(0)))
    tree = tparams.from_reference(host, device="cpu")
    back = tparams.to_host(tree)
    assert jax.tree.structure(back) == jax.tree.structure(host)
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, a)
    # bfloat16 leaves (ml_dtypes on the jax side) keep their bits
    hb = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                      host)
    tb = tparams.from_reference(hb, device="cpu")
    leaf = tb["segments"]["main"]["L0.mix.wq"]
    assert leaf.dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(hb), jax.tree.leaves(
            tparams.to_host(tb))):
        np.testing.assert_array_equal(b, a.astype(np.float32))


def test_init_all_params_follows_param_specs():
    tcfg, trc = tllama.reduced()
    p = tparams.init_all_params(tcfg, trc, torch.Generator().manual_seed(3),
                                device="cpu")
    geo = tmodel.build_geometry(tcfg, trc)
    specs = tmodel.stage_specs(tcfg, geo.segments[0])
    seg = p["segments"]["main"]
    assert set(seg) == set(specs)
    for n, sp in specs.items():
        assert tuple(seg[n].shape) == (geo.seg_stages(geo.segments[0]),
                                       *sp.shape)
        if sp.init == "ones":
            assert bool((seg[n] == 1).all())
    io = p["io"]
    assert set(io) == set(tmodel.io_specs(tcfg))
    std = float(io["embed.table"].std())
    assert abs(std - 1 / np.sqrt(tcfg.vocab)) < 0.2 / np.sqrt(tcfg.vocab)
    again = tparams.init_all_params(
        tcfg, trc, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(again["io"]["embed.table"], io["embed.table"])


def test_session_refuses_what_the_slice_lacks(monkeypatch):
    # wider layouts train on several ranks: one process without a
    # process group is refused
    with pytest.raises(SessionError, match="process group"):
        session("llama3.2-1b", mode="train", device="cpu",
                overrides=dict(pp=2))
    with pytest.raises(SessionError, match="process group"):
        session("llama3.2-1b", mode="train", device="cpu", data=2)
    with pytest.raises(SessionError, match="unknown architecture"):
        session("qwen2-moe-a2.7b", max_seq=16, device="cpu")
    with pytest.raises(SessionError, match="one rank"):
        session("llama3.2-1b", max_seq=16, data=2, device="cpu")
    with pytest.raises(SessionError, match="page_size"):
        session("llama3.2-1b", max_seq=16, kv_cache_dtype="int8",
                device="cpu")
    # the card is the default device, and its absence is an error
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SessionError, match="no GPU"):
        session("llama3.2-1b", max_seq=16)


@pytest.mark.parametrize("field,value", [("norm", "layernorm"),
                                         ("act", "gelu_mlp")])
def test_session_refuses_norms_and_mlps_it_does_not_compute(
        monkeypatch, field, value):
    """Training computes LayerNorm and the GELU MLP; the serve path
    computes RMSNorm and SwiGLU only, so a serve session of a config
    asking for LayerNorm or the GELU MLP is refused (GPT serving,
    ROADMAP.md queue 1 item 2), and so is any norm or MLP the port has no
    block for."""
    cfg, rc = tllama.reduced()
    monkeypatch.setattr(tllama, "reduced", lambda: (
        dataclasses.replace(cfg, **{field: value}), rc))
    session("llama3.2-1b", mode="train", device="cpu")
    with pytest.raises(SessionError, match="queue 1 item 2"):
        session("llama3.2-1b", mode="serve", max_seq=16, device="cpu")
    monkeypatch.setattr(tllama, "reduced", lambda: (
        dataclasses.replace(cfg, **{field: "unknown"}), rc))
    with pytest.raises(SessionError, match="the port computes"):
        session("llama3.2-1b", mode="train", device="cpu")


def test_import_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.launch.serve, "
            "repro_torch.kernels.build; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {"PYTHONPATH": str(PKG.parent), "PATH": "/usr/bin:/bin"}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_port_module_imports_repro_or_jax():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 15
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            for r in roots:
                assert r not in ("repro", "jax", "jaxlib"), (f, r)
