"""The port does what the JAX package does: every module of
``visionx_slam_tpu/`` has its counterpart in ``visionx_slam_torch/``, every
public top-level name of a JAX module is defined in its counterpart (or
imported there by name), and every keyword default of a public function
that both define is the port's default too, directly or through the
``**kw`` the port's function passes on. The source is read with ``ast``:
neither package is imported.

The same holds for every function both modules define (private ones
too) and for the fields and public methods of every public class both
define. A JAX name, keyword or default that the port lacks fails here until it is
ported, or until ``EXCEPTIONS`` lists it with its reason (they mirror
ROADMAP.md's "Not to port")."""

from __future__ import annotations

import ast
import functools
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "visionx_slam_tpu"
PORT_PKG = ROOT / "visionx_slam_torch"

# JAX module -> the port's module of another name
RENAMES = {
    "models/orb_jax.py": "models/orb_torch.py",
    "ops/pallas_detect.py": "ops/detect.py",
}

# (JAX module, name) or (JAX module, function, keyword) -> why the port
# has no counterpart
EXCEPTIONS = {
    ("models/orb_jax.py", "JaxOrbExtractor"):
        "the port's TorchOrbExtractor runs under extractor=jax",
    ("models/orb_jax.py", "FAST_RADIUS"):
        "unused in the JAX package; FAST_CIRCLE holds the radius",
    ("models/orb_jax.py", "HARRIS_K"):
        "defined in ops/detect.py, beside the plain K1 that uses it",
    ("models/orb_jax.py", "HARRIS_BLOCK"):
        "defined in ops/detect.py, beside the plain K1 that uses it",
    ("models/orb_jax.py", "orb_extract", "use_pallas"):
        "the Pallas switch; the port's use_kernel picks K1 or its plain version",
    ("models/orb_jax.py", "orb_extract", "patch_cell"):
        "the TPU gather's tiling; the one-hot selection is exact without it",
    ("models/orb_jax.py", "orb_extract", "profile_stage"):
        "the JAX package times a jitted step by compiling shortened copies "
        "of it; the port times the real step from inside with the stage "
        "clock's spans",
    ("ops/camera.py", "make_camera", "dtype"):
        "no caller passes it; the port's camera holds float32-rounded floats",
    ("ops/pallas_detect.py", "PAD_K"):
        "the Pallas kernel's halo rows; K1's CUDA launch has its own geometry",
    ("ops/pallas_detect.py", "fast_harris_blur", "block_rows"):
        "the Pallas grid's block; K1's CUDA launch has its own geometry",
    ("ops/pallas_detect.py", "fast_harris_score", "block_rows"):
        "the Pallas grid's block; K1b's CUDA launch has its own geometry",
    ("tracking/offline_pipeline.py", "build_keyframe_map", "retriangulate"):
        "nothing sets it: the JAX pipeline passes False",
    ("tracking/offline_pipeline.py", "build_keyframe_map", "takeover"):
        "nothing sets it: the JAX pipeline passes False",
    ("tracking/offline_pipeline.py", "_link_consecutive_keyframes", "takeover"):
        "build_keyframe_map's takeover, which nothing sets",
    ("tracking/offline_pipeline.py", "_close_loops", "ransac_hypotheses"):
        "unused by the JAX function: pairs are verified by matches and rotation",
    ("tracking/scan_pipeline.py", "frame_keys"):
        "JAX PRNG key plumbing; the port's analogue is frame_generator",
    ("tracking/scan_pipeline.py", "build_scan_step", "orb_kwargs"):
        "the port's step takes features extracted ahead of it; "
        "run_scan_pipeline takes orb_kwargs",
    ("tracking/scan_pipeline.py", "build_scan_step", "batched"):
        "marks a step run under jax.vmap; the port runs each lane's loop",
    ("tracking/scan_pipeline.py", "build_scan_step", "stage_limit"):
        "the JAX package times a jitted step by compiling shortened copies "
        "of it; the port times the real step from inside with the stage "
        "clock's spans",
    ("tracking/scan_pipeline.py", "run_scan_pipeline", "stage_limit"):
        "the JAX package times a jitted step by compiling shortened copies "
        "of it; the port times the real step from inside with the stage "
        "clock's spans",
    ("utils/logging.py", "StageTimer"):
        "the port's System times its stages on StageClock",
    ("utils/flops.py", "xla_cost"):
        "XLA's cost analysis; the port counts aten ops with op_cost",
}


def _jax_modules() -> list[str]:
    return sorted(p.relative_to(JAX_PKG).as_posix() for p in JAX_PKG.rglob("*.py"))


def _counterpart(rel: str) -> str:
    return RENAMES.get(rel, rel)


@functools.lru_cache(maxsize=None)
def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), str(path))


def _top_level(tree: ast.Module):
    """The module's top-level statements, into if/try/with blocks."""
    todo = list(tree.body)
    while todo:
        node = todo.pop(0)
        if isinstance(node, (ast.If, ast.Try, ast.With)):
            for field in ("body", "orelse", "finalbody"):
                todo.extend(getattr(node, field, []))
            for h in getattr(node, "handlers", []):
                todo.extend(h.body)
        else:
            yield node


def _defined(tree: ast.Module) -> dict[str, ast.AST]:
    """Top-level functions, classes and assigned names."""
    out: dict[str, ast.AST] = {}
    for node in _top_level(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                for n in ast.walk(tgt):
                    if isinstance(n, ast.Name):
                        out[n.id] = node
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out[node.target.id] = node
    return out


def _imported(tree: ast.Module, rel: str) -> dict[str, tuple[str, str] | None]:
    """Names imported at the top level -> (port module, name) for an import
    from within the port, None for any other."""
    out: dict[str, tuple[str, str] | None] = {}
    pkg = Path(rel).parent
    for node in _top_level(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[(a.asname or a.name).split(".")[0]] = None
        elif isinstance(node, ast.ImportFrom):
            src = None
            if node.level:
                base = pkg
                for _ in range(node.level - 1):
                    base = base.parent
                mod = (node.module or "").replace(".", "/")
                src = (base / mod).as_posix().lstrip("./") + ".py"
            elif (node.module or "").startswith("visionx_slam_torch."):
                src = node.module.split(".", 1)[1].replace(".", "/") + ".py"
            for a in node.names:
                out[a.asname or a.name] = (src, a.name) if src else None
    return out


def _public(names) -> list[str]:
    return sorted(n for n in names if not n.startswith("_"))


def _norm(expr: ast.AST) -> str:
    return ast.unparse(expr).replace("jnp.", "torch.")


def _defaults(fn: ast.FunctionDef) -> dict[str, str]:
    a = fn.args
    pos = a.posonlyargs + a.args
    out = {p.arg: _norm(d) for p, d in zip(pos[len(pos) - len(a.defaults):], a.defaults)}
    out.update({p.arg: _norm(d) for p, d in zip(a.kwonlyargs, a.kw_defaults)
                if d is not None})
    return out


def _resolve_fn(rel: str, name: str, depth: int = 0) -> ast.FunctionDef | None:
    """The port's function ``name`` as seen from module ``rel``: defined
    there or imported from another port module."""
    path = PORT_PKG / rel
    if depth > 4 or not path.is_file():
        return None
    tree = _tree(path)
    node = _defined(tree).get(name)
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return node
    src = _imported(tree, rel).get(name)
    return _resolve_fn(src[0], src[1], depth + 1) if src else None


def _port_default(rel: str, fn: ast.FunctionDef, key: str, depth: int = 0):
    """The port function's default for ``key``: its own, or, where it takes
    ``**kw``, that of a function it passes ``**kw`` to."""
    own = _defaults(fn)
    if key in own or depth > 4:
        return own.get(key)
    if fn.args.kwarg is None:
        return None
    kw = fn.args.kwarg.arg
    for call in ast.walk(fn):
        if not isinstance(call, ast.Call):
            continue
        if not any(k.arg is None and isinstance(k.value, ast.Name) and k.value.id == kw
                   for k in call.keywords):
            continue
        f = call.func
        callee = f.id if isinstance(f, ast.Name) else getattr(f, "attr", None)
        target = _resolve_fn(rel, callee) if callee else None
        if target is not None:
            found = _port_default(rel, target, key, depth + 1)
            if found is not None:
                return found
    return None


def _functions(nodes) -> dict[str, ast.FunctionDef]:
    return {f.name: f for f in nodes
            if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _fields(cls: ast.ClassDef) -> dict[str, str]:
    """Annotated class attributes with a value (dataclass and NamedTuple
    fields) -> their default."""
    return {s.target.id: _norm(s.value) for s in cls.body
            if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name)
            and s.value is not None}


def test_the_exceptions_are_current():
    """Each exception names what the JAX package has and the port lacks:
    one that no longer does is stale and goes."""
    for key in EXCEPTIONS:
        rel = key[0]
        node = _defined(_tree(JAX_PKG / rel)).get(key[1])
        assert node is not None, key
        port_tree = _tree(PORT_PKG / _counterpart(rel))
        if len(key) == 2:
            assert key[1] not in (set(_defined(port_tree))
                                  | set(_imported(port_tree, _counterpart(rel)))), key
        else:
            assert key[2] in _defaults(node), key
            pfn = _resolve_fn(_counterpart(rel), key[1])
            assert pfn is None or _port_default(_counterpart(rel), pfn,
                                                key[2]) is None, key


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_jax_module_has_its_counterpart(rel):
    assert (PORT_PKG / _counterpart(rel)).is_file(), (
        f"visionx_slam_tpu/{rel} has no counterpart "
        f"visionx_slam_torch/{_counterpart(rel)}")


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_public_name_is_ported(rel):
    port_rel = _counterpart(rel)
    jax_names = _public(_defined(_tree(JAX_PKG / rel)))
    port_tree = _tree(PORT_PKG / port_rel)
    have = set(_defined(port_tree)) | set(_imported(port_tree, port_rel))
    missing = [n for n in jax_names if n not in have and (rel, n) not in EXCEPTIONS]
    assert not missing, (
        f"visionx_slam_tpu/{rel} defines {missing}, which "
        f"visionx_slam_torch/{port_rel} lacks: port them or list each in "
        f"EXCEPTIONS with its reason")


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_keyword_default_is_ported(rel):
    """Every function both modules define, public or not: each JAX keyword
    default is the port's, its own or through its ``**kw``."""
    port_rel = _counterpart(rel)
    jax_fns = _functions(_defined(_tree(JAX_PKG / rel)).values())
    port_fns = _functions(_defined(_tree(PORT_PKG / port_rel)).values())
    wrong = []
    for name in sorted(set(jax_fns) & set(port_fns)):
        for key, value in _defaults(jax_fns[name]).items():
            if (rel, name, key) in EXCEPTIONS:
                continue
            got = _port_default(port_rel, port_fns[name], key)
            if got != value:
                wrong.append(f"{name}({key}={value}): the port has "
                             f"{'no such keyword' if got is None else got}")
    assert not wrong, (
        f"visionx_slam_torch/{port_rel} differs from visionx_slam_tpu/{rel}: "
        + "; ".join(wrong))


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_class_field_and_method_is_ported(rel):
    """Every public class both modules define: its fields with their
    defaults (configuration dataclasses, NamedTuples) and its public
    methods with their keyword defaults."""
    port_rel = _counterpart(rel)
    jax_defs = _defined(_tree(JAX_PKG / rel))
    port_defs = _defined(_tree(PORT_PKG / port_rel))
    wrong = []
    for name in _public(jax_defs):
        cls, pcls = jax_defs[name], port_defs.get(name)
        if not (isinstance(cls, ast.ClassDef) and isinstance(pcls, ast.ClassDef)):
            continue
        pfields = _fields(pcls)
        for key, value in _fields(cls).items():
            if pfields.get(key) != value:
                wrong.append(f"{name}.{key} = {value}: the port has "
                             f"{pfields.get(key, 'no such field')}")
        pmethods = _functions(pcls.body)
        for m, fn in _functions(cls.body).items():
            if m.startswith("_") and m != "__init__":
                continue
            if m not in pmethods:
                wrong.append(f"{name}.{m}: the port has no such method")
                continue
            pdef = _defaults(pmethods[m])
            for key, value in _defaults(fn).items():
                if pdef.get(key) != value:
                    wrong.append(f"{name}.{m}({key}={value}): the port has "
                                 f"{pdef.get(key, 'no such keyword')}")
    assert not wrong, (
        f"visionx_slam_torch/{port_rel} differs from visionx_slam_tpu/{rel}: "
        + "; ".join(wrong))
