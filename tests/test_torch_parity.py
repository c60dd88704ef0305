"""The port's public surface against the JAX package's: the signatures of
the exports and of every module's public functions, each module's public
names, the `.bed` helpers, the placeholder packages, REML's `precision=`,
the rule that nothing of the port imports JAX, and the examples' twins."""
import ast
import importlib
import inspect
import math
import pkgutil
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import gmat_tpu
import gmat_tpu_torch
from gmat_tpu.io import bed as jbed
from gmat_tpu_torch import config
from gmat_tpu_torch.io import bed as tbed
from gmat_tpu_torch.reml import wemai as twemai

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"

# ROADMAP's "do not port" list: the JAX package's TPU-only public names
# (None: the whole module)
DO_NOT_PORT = {
    "gmat_tpu.config": {"RemlConfig", "ScanConfig", "host_device_count",
                        "default_exact_dtype"},
    "gmat_tpu.core.devcache": None,
    "gmat_tpu.core.linalg": {"mixed_inv_psd"},
    "gmat_tpu.dist.mesh": {"AXIS"},
    "gmat_tpu.scan.kernels": {
        "mosaic_probe", "engine_choice", "disable_pallas", "PallasDenseError",
        # the Pallas entry points: the port's kernel wrappers screen_counts,
        # screen_extract, screen_hits and exact_hits replace them
        "pallas_screen_counts", "pallas_extract_hot_tiles", "pallas_screen",
        "extract_tile_hits", "pallas_exact_scan", "pallas_exact_hits"},
}
# public functions whose parameters depart from the JAX package's on purpose
SIGNATURE_EXCEPTIONS = {
    # the default logger name is the port's own package
    "gmat_tpu.common.get_logger",
    # `mixed=` selects the TPU's mixed-precision inverse (do not port)
    "gmat_tpu.core.linalg.projection_pieces",
}
JAX_MODULES = sorted(m.name for m in pkgutil.walk_packages(
    gmat_tpu.__path__, "gmat_tpu."))


def _same_default(a, b):
    if a is b:
        return True
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return type(a) is type(b) and a == b


def _extends(jfn, tfn):
    """The JAX callable's parameters are an ordered prefix of the port's
    (same names, kinds and defaults), and the port's extra ones have
    defaults: every JAX-side call, positional or keyword, binds the same."""
    pj = list(inspect.signature(jfn).parameters.values())
    pt = list(inspect.signature(tfn).parameters.values())
    return (len(pj) <= len(pt)
            and all(a.name == b.name and a.kind == b.kind
                    and _same_default(a.default, b.default)
                    for a, b in zip(pj, pt))
            and all(p.default is not p.empty or p.kind is p.VAR_KEYWORD
                    for p in pt[len(pj):]))


def _public(mod):
    """The module's own public functions (jitted ones too) and classes,
    and its upper-case constants."""
    out = {}
    for name, val in vars(mod).items():
        if name.startswith("_") or isinstance(val, types.ModuleType):
            continue
        if callable(val):
            if getattr(val, "__module__", None) == mod.__name__:
                out[name] = val
        elif name.isupper():
            out[name] = val
    return out


def test_exports_extend_jax_signatures():
    names = [n for n in dir(gmat_tpu) if not n.startswith("__")
             and not isinstance(getattr(gmat_tpu, n), types.ModuleType)]
    assert len(names) > 90
    bad = [n for n in names if callable(getattr(gmat_tpu, n))
           and not _extends(getattr(gmat_tpu, n), getattr(gmat_tpu_torch, n))]
    assert bad == []


@pytest.mark.parametrize("jname", JAX_MODULES)
def test_module_names_and_signatures(jname):
    """Each JAX module has its twin in the port, which holds its public
    names apart from `DO_NOT_PORT` and extends each public function's
    parameters apart from `SIGNATURE_EXCEPTIONS`."""
    skip = DO_NOT_PORT.get(jname, set())
    if skip is None:
        return
    jmod = importlib.import_module(jname)
    tmod = importlib.import_module("gmat_tpu_torch" + jname[len("gmat_tpu"):])
    public = _public(jmod)
    assert skip <= set(public), "a do-not-port name is gone from the JAX side"
    missing = sorted(n for n in public if n not in skip
                     and not hasattr(tmod, n))
    assert missing == []
    bad = [n for n, fn in public.items()
           if callable(fn) and not inspect.isclass(fn)
           and n not in skip and f"{jname}.{n}" not in SIGNATURE_EXCEPTIONS
           and not _extends(fn, getattr(tmod, n))]
    assert bad == []


def test_wemai_reml_extends_jax():
    from gmat_tpu.reml.wemai import wemai_reml

    assert _extends(wemai_reml, twemai.wemai_reml)


@pytest.mark.parametrize("name", ["bayes", "mdlearn", "mvlmm"])
def test_placeholder_packages_import(name):
    mod = importlib.import_module(f"gmat_tpu_torch.{name}")
    assert mod.__doc__ and not _public(mod)


def test_unpack_codes_device_matches_jax(mouse_prefix):
    import jax.numpy as jnp

    b = jbed.Bed(mouse_prefix)
    raw = jbed.read_bed_raw(mouse_prefix + ".bed", b.num_id, b.num_snp)
    want = np.asarray(jbed.unpack_codes_device(jnp.asarray(raw), b.num_id))
    got = tbed.unpack_codes_device(torch.as_tensor(raw), b.num_id)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert got.shape == (b.num_id, b.num_snp)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tbed.read_plink(mouse_prefix))


@pytest.mark.parametrize("num_id", [4, 3])
def test_unpack_codes_device_hand_packed(monkeypatch, num_id):
    """Codes 0..3 in one byte (0 at the low bits), a finite missing value,
    and a numpy input, which goes to the default device."""
    import jax.numpy as jnp

    raw = np.array([[0b11100100], [0b00011011]], dtype=np.uint8)
    want = np.array([[0.0, -9.0, 1.0, 2.0], [2.0, 1.0, -9.0, 0.0]]).T[:num_id]
    jax_got = np.asarray(jbed.unpack_codes_device(jnp.asarray(raw), num_id,
                                                  missing_value=-9.0))
    monkeypatch.setattr(config, "DEFAULT_DEVICE", torch.device("cpu"))
    got = tbed.unpack_codes_device(raw, num_id, missing_value=-9.0)
    np.testing.assert_array_equal(jax_got, want)
    np.testing.assert_array_equal(got.numpy(), want)


def test_count_lines_matches_jax(mouse_prefix):
    path = mouse_prefix + ".bim"
    assert tbed.count_lines(path) == jbed.count_lines(path) == 1407


# REML's precision= ------------------------------------------------------------

@pytest.fixture(scope="module")
def reml_inputs(mouse_pheno, mouse_prefix):
    from gmat_tpu_torch.grm.grm import additive_grm
    from gmat_tpu_torch.io.pheno import design_matrix

    ag = additive_grm(torch.as_tensor(tbed.read_plink(mouse_prefix))).numpy()
    return design_matrix(mouse_pheno, mouse_prefix), [ag, ag * ag]


@pytest.fixture(scope="module")
def reml_default(reml_inputs):
    dm, gmat_lst = reml_inputs
    return twemai.wemai_reml(dm, gmat_lst, maxiter=2, device="cpu")


@pytest.mark.parametrize("precision", ["auto", "f64", "mixed", "F64"])
def test_reml_precision_values_run_float64(reml_inputs, reml_default,
                                           precision):
    dm, gmat_lst = reml_inputs
    got = twemai.wemai_reml(dm, gmat_lst, maxiter=2, precision=precision,
                            device="cpu")
    np.testing.assert_array_equal(got, reml_default)


@pytest.mark.parametrize("fn", ["wemai_multi_gmat", "wemai_multi_gmat_pred"])
def test_file_level_precision_mixed_runs_float64(tmp_path, mouse_pheno,
                                                 mouse_prefix, reml_inputs,
                                                 fn):
    _, gmat_lst = reml_inputs
    call = getattr(twemai, fn)
    want = call(mouse_pheno, mouse_prefix, gmat_lst, maxiter=1,
                out_file=str(tmp_path / "auto"), device="cpu")
    got = call(mouse_pheno, mouse_prefix, gmat_lst, maxiter=1,
               out_file=str(tmp_path / "mixed"), precision="mixed",
               device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["wemai_reml", "wemai_multi_gmat",
                                "wemai_multi_gmat_pred"])
def test_unknown_precision_raises_before_any_work(tmp_path, fn):
    """No design, GRM or file is read or written: the value is checked
    first, with the JAX package's message."""
    absent = str(tmp_path / "absent")
    args = (None, None) if fn == "wemai_reml" else (absent, absent, None)
    kw = {} if fn == "wemai_reml" else {"out_file": absent}
    with pytest.raises(ValueError, match="unknown REML precision 'bf16'"):
        getattr(twemai, fn)(*args, precision="bf16", device="cpu", **kw)
    assert not any(tmp_path.iterdir())


# what the port imports, and the examples ------------------------------------

def _imports(path):
    """The top-level module of every import and `import_module` /
    `__import__` of a constant name in the file."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value.split(".")[0]


def test_port_imports_no_jax():
    files = (sorted((ROOT / "gmat_tpu_torch").rglob("*.py"))
             + sorted((EXAMPLES / "torch").rglob("*.py"))
             + [ROOT / "chip_smoke.py", ROOT / "tools" / "run_torch_examples.py"])
    assert len(files) > 50
    bad = [(str(p.relative_to(ROOT)), name) for p in files
           for name in _imports(p) if name in ("jax", "jaxlib", "gmat_tpu")]
    assert bad == []


JAX_EXAMPLES = sorted(str(p.relative_to(EXAMPLES))
                      for p in EXAMPLES.rglob("*.py")
                      if p.relative_to(EXAMPLES).parts[0] != "torch")


@pytest.mark.parametrize("rel", JAX_EXAMPLES)
def test_jax_example_has_torch_twin(rel):
    """Each example script has its twin under examples/torch/, which
    imports the port and reads `--device`."""
    twin = EXAMPLES / "torch" / rel
    assert twin.is_file()
    names = set(_imports(twin))
    tree = ast.parse(twin.read_text())
    if rel == "_common.py":
        assert any(isinstance(n, ast.Constant) and n.value == "--device"
                   for n in ast.walk(tree))
    else:
        assert "gmat_tpu_torch" in names
        assert any(isinstance(n, ast.Call)
                   and getattr(n.func, "id", None) == "parse_device"
                   for n in ast.walk(tree))
