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

from repro.api import get_arch as jget_arch  # noqa: E402
from repro.configs import gpt_paper as jgpt  # noqa: E402
from repro.configs import llama3p2_1b as jllama  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import params as tparams  # noqa: E402
from repro_torch.api import SessionError, get_arch, session  # noqa: E402
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


# the reference's llama-class dense decoders (head_dim 128, untied head)
# and their parameter counts at full width and depth, from the ParamSpecs
DENSE = {"yi-9b": 8_829_407_232, "minitron-4b": 5_096_279_040,
         "phi4-mini-3.8b": 4_450_618_368}


@pytest.mark.parametrize("arch", list(DENSE))
def test_dense_arch_configs_equal_reference_field_by_field(arch):
    """``config()`` and ``reduced()`` of yi-9b, minitron-4b and phi4-mini
    equal the reference's; the one-card serve run is pp 1 in bf16 and the
    train run zeropp at vpp 2; the serve session at full width counts
    the parameters the config modules' docstrings state."""
    tmod, jmod = get_arch(arch), jget_arch(arch)
    assert _fields(tmod.config()) == _fields(jmod.config())
    for t, j in zip(tmod.reduced(), jmod.reduced()):
        assert _fields(t) == _fields(j)
    cfg = tmod.config()
    assert (cfg.head_dim, cfg.norm, cfg.act, cfg.tie_embeddings) == (
        128, "rmsnorm", "swiglu", False)
    one = tmod.one_card_run()
    assert (one.pp, one.vpp, one.microbatches) == (1, 1, 1)
    assert one.param_dtype == one.compute_dtype == "bfloat16"
    rc = tmod.one_card_train_run()
    assert (rc.pp, rc.vpp, rc.schedule) == (1, 2, "zeropp")
    n = session(arch, reduced=False, max_seq=64,
                device="cpu").describe()["n_params"]
    assert n == DENSE[arch]
    assert f"{n:,}" in tmod.one_card_run.__doc__
    assert f"{n:,}" in tmod.one_card_train_run.__doc__


@pytest.mark.parametrize("arch", list(DENSE))
@pytest.mark.parametrize("full", [True, False])
def test_dense_arch_param_specs_equal_reference(arch, full):
    """Segments and stage and io specs name for name, at the reduced
    config's pp and vpp (yi-9b: pp 2, vpp 3)."""
    tmod, jmod = get_arch(arch), jget_arch(arch)
    cfg = jmod.config() if full else jmod.reduced()[0]
    tcfg = tmod.config() if full else tmod.reduced()[0]
    jgeo = jmodel.build_geometry(cfg, jmod.reduced()[1])
    tgeo = tmodel.build_geometry(tcfg, tmod.reduced()[1])
    assert tgeo.pp == jgeo.pp
    for js, ts in zip(jgeo.segments, tgeo.segments, strict=True):
        assert _fields(ts) == _fields(js)
        assert tgeo.seg_stages(ts) == jgeo.seg_stages(js)
        jspec = {n: _fields(s) for n, s in jmodel.stage_specs(cfg, js).items()}
        tspec = {n: _fields(s)
                 for n, s in tmodel.stage_specs(tcfg, ts).items()}
        assert tspec == jspec
    assert {n: _fields(s) for n, s in tmodel.io_specs(tcfg).items()} == \
        {n: _fields(s) for n, s in jmodel.io_specs(cfg).items()}


# the two archs of the MoE-shared-experts and vision-stub slice: their
# serve (full depth) and train-cut parameter counts, from the ParamSpecs,
# and their train cuts' depths
SLICE = {"qwen2-moe-a2.7b": (14_315_587_584, 2_333_988_864, 3),
         "phi-3-vision-4.2b": (3_821_079_552, 2_009_041_920, 16)}


@pytest.mark.parametrize("arch", list(SLICE))
def test_slice_arch_configs_equal_reference_field_by_field(arch):
    """``config()`` and ``reduced()`` of qwen2-moe-a2.7b and
    phi-3-vision-4.2b equal the reference's; the serve run is pp 1 in
    bf16, the train run zeropp at pp 1; the full-width serve and train
    sessions count the parameters the config modules' docstrings state,
    the train cut at its widths (qwen: all 60 experts and the shared
    FFN); their specs equal the reference's at both."""
    tmod, jmod = get_arch(arch), jget_arch(arch)
    assert _fields(tmod.config()) == _fields(jmod.config())
    for t, j in zip(tmod.reduced(), jmod.reduced()):
        assert _fields(t) == _fields(j)
    one = tmod.one_card_run()
    assert (one.pp, one.vpp, one.microbatches) == (1, 1, 1)
    assert one.param_dtype == one.compute_dtype == "bfloat16"
    rc = tmod.one_card_train_run()
    assert (rc.pp, rc.microbatches, rc.unit, rc.schedule) == (
        1, 4, 2, "zeropp")
    assert (tmod.TRAIN_SEQ, tmod.TRAIN_BATCH) == (4096, 4)
    n_serve, n_train, depth = SLICE[arch]
    cut = tmod.one_card_train_config()
    assert cut == dataclasses.replace(tmod.config(), n_layers=depth)
    s = session(arch, reduced=False, max_seq=64, device="cpu")
    t = session(arch, mode="train", reduced=False, device="cpu")
    assert (s.describe()["n_params"], t.describe()["n_params"]) == (
        n_serve, n_train)
    assert t.cfg == cut and t.rc == rc
    assert f"{n_serve:,}" in tmod.one_card_run.__doc__
    assert f"{n_train:,}" in tmod.one_card_train_config.__doc__
    for full in (True, False):
        jcfg = jmod.config() if full else jmod.reduced()[0]
        tcfg = tmod.config() if full else tmod.reduced()[0]
        jgeo = jmodel.build_geometry(jcfg, jmod.reduced()[1])
        tgeo = tmodel.build_geometry(tcfg, tmod.reduced()[1])
        for js, ts in zip(jgeo.segments, tgeo.segments, strict=True):
            assert _fields(ts) == _fields(js)
            assert {n: _fields(x) for n, x in tmodel.stage_specs(
                tcfg, ts).items()} == {n: _fields(x) for n, x in
                                       jmodel.stage_specs(jcfg, js).items()}
        assert {n: _fields(x) for n, x in tmodel.io_specs(tcfg).items()} \
            == {n: _fields(x) for n, x in jmodel.io_specs(jcfg).items()}


def test_every_reference_id_of_a_registered_arch_resolves():
    """Each canonical name and alias of the reference's registry resolves
    in the port to the same architecture, wherever the port registers
    it: 10 of the reference's 11. The other one is refused, naming the
    roadmap item that brings it."""
    from repro.api import registry as jreg
    from repro_torch.api import registry as treg
    assert len(treg.list_archs()) == 10
    ported = set(treg.list_archs())
    missing = set()
    for name, aliases in jreg._BUILTIN_ARCHS.items():
        if name not in ported:
            missing.add(name)
            for a in (name, *aliases):
                with pytest.raises(treg.RegistryError, match="6e"):
                    get_arch(a)
            continue
        want = jget_arch(name).config().name
        for a in (name, *aliases):
            assert get_arch(a).config().name == want, a
    assert missing == {"deepseek_v3_671b"}


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
        session("deepseek-v3-671b", max_seq=16, device="cpu")
    # a serve session on a mesh, too (multi-rank serving)
    with pytest.raises(SessionError, match="process group"):
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
    """Training and serving compute LayerNorm and the GELU MLP beside
    RMSNorm and SwiGLU, so sessions of a config asking for either build
    in both modes; a norm or MLP the port has no block for is refused in
    both modes, before any device work."""
    cfg, rc = tllama.reduced()
    monkeypatch.setattr(tllama, "reduced", lambda: (
        dataclasses.replace(cfg, **{field: value}), rc))
    session("llama3.2-1b", mode="train", device="cpu")
    sess = session("llama3.2-1b", mode="serve", max_seq=16, device="cpu")
    assert getattr(sess.cfg, field) == value
    monkeypatch.setattr(tllama, "reduced", lambda: (
        dataclasses.replace(cfg, **{field: "unknown"}), rc))
    for mode in ("train", "serve"):
        with pytest.raises(SessionError, match="the port computes"):
            session("llama3.2-1b", mode=mode, max_seq=16, device="cpu")


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
