"""The port's inventory: every public name of the JAX package has its
counterpart in `densemonoslam_tpu_torch/`, or a stated reason why it has
none, and every example entry point has its `torch_` twin.

Each module of `densemonoslam_tpu/` is parsed with `ast` (nothing of it is
imported, so jax is not needed).  For each public top-level function and
class, and each public method of a public class (flax's `__call__`
included), the port's module of the same path must define the same name, or
`COUNTERPARTS` must map it to the port's name for it, or `NO_COUNTERPART`
must give a reason.  One case per module, so a missing name fails only its
module's case."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "densemonoslam_tpu"
PORT = REPO / "densemonoslam_tpu_torch"
EXAMPLES = REPO / "examples"

# JAX module -> {JAX name: "port module:port name"}: the same job under
# another name or in another module.  A name the port's module imports counts
# as its own (`ops/reductions.py` imports K1's wrapper `ops/gram.py:gram`, so
# `reductions.gram` resolves).
COUNTERPARTS = {
    "ops/histogram.py": {
        "joint_histogram_matmul": "ops/histogram.py:joint_histogram",
        "joint_histogram_scatter": "ops/histogram.py:joint_histogram",
    },
    "ops/pallas/gram.py": {"gram_pallas": "ops/gram.py:gram"},
    "ops/pallas/deform.py": {
        "deform_soa_pallas": "ops/deform.py:deform_map",
        "deform_points_pallas": "mapping/deformation.py:deform_points",
    },
    "models/onnx_import.py": {"onnx_conv_to_flax": "models/onnx_import.py:torch_conv_to_flax"},
    "models/depthnet.py": {
        "ConvBlock.__call__": "models/depthnet.py:ConvBlock.forward",
        "DepthNet.__call__": "models/depthnet.py:DepthNet.forward",
    },
}

# JAX module -> {JAX name: why the port has none}.  Private names appear
# here only where they are a job of their own that the port does otherwise.
NO_COUNTERPART = {
    "utils/jax_cache.py": {
        "enable": "XLA's persistent compilation cache; the port compiles no XLA program, and "
                  "its kernels are built once per source hash (ops/cuda_build.py)",
    },
    "parallel/mesh.py": {
        "cam_sharding": "a jax NamedSharding over the camera axis; torch has no sharding type: "
                        "a rank holds its own cameras",
        "replicated": "a jax NamedSharding with no axis; torch has no sharding type",
    },
    "models/depthnet.py": {
        "DepthPredictor.init_for": "flax initialises its parameters from an input shape; a "
                                   "torch module has them from construction",
    },
    "mapping/deformation.py": {
        "_on_tpu": "picks the Pallas kernel on a TPU; the port picks K2 by the tensor's device "
                   "(ops/deform.py:deform_map)",
    },
    "loops.py": {
        "_make_local_loop": "a jax.jit factory cached per shape; the port runs the local loop "
                            "op by op around its graphed GN-CG until ROADMAP Queue 1 step 17 "
                            "captures it as a CUDA graph (loops.py:try_local_loop)",
        "_make_hybrid_loop": "a jax.jit factory cached per shape; the port runs the hybrid loop "
                             "op by op around its graphed GN-CG until ROADMAP Queue 1 step 17 "
                             "captures it as a CUDA graph (loops.py:apply_hybrid_loop)",
    },
    "engine.py": {
        "_intensity_and_depth": "one jitted program for luma and metric depth; the port's step "
                                "does both as eager ops",
        "_hist_append": "the jitted history scatter; the port's Frontend._flush_hist does it "
                        "as one indexed write per tensor",
    },
}

# JAX module -> {the jitted program: (where the JAX package compiles it,
# the port's CUDA graph of it)}: the programs the JAX package compiles into
# one device program per call, which the port captures and replays on the
# card (`utils/graphs.py`)
COMPILED = {
    "step.py": {"make_step": ("jax.jit(step, donate_argnums=(0,))", "step.py:make_graphed_step")},
    "mapping/deformation.py": {
        "optimise": ('@functools.partial(jax.jit, static_argnames=("iters", "cg_iters"))',
                     "mapping/deformation.py:optimise_graphed"),
    },
}

# JAX examples with no twin: each asks how XLA lowers the JAX package's
# control flow, which the port, running eagerly, does not have; the reason
# names the question and the twin that answers the timing question for the
# port.
NO_TWIN = {
    "profile_bisect.py": "asks whether XLA's while_loop iterations or one lowering of the composed "
                         "render cost its milliseconds; the port's eager render has neither, and "
                         "torch_profile_render.py times its phases",
    "profile_bisect2.py": "asks whether while_loop, fori_loop or unrolled loops cost least per "
                          "iteration under XLA, to choose how GN loops are written; the port's "
                          "loops are Python loops, and torch_profile_stages.py times track_gn",
    "profile_chained.py": "chains each stage in a lax.scan so that XLA serialises the device work "
                          "it times; the port reads device time from torch.profiler "
                          "(torch_xbench.py, used by torch_profile_stages.py and "
                          "torch_profile_micro.py)",
}


def _public_names(path: Path) -> set:
    """Public top-level functions and classes, and the public methods (and
    `__call__`) of public classes, as `name` / `Class.method`."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        if node.name.startswith("_"):
            continue
        out.add(node.name)
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                        not sub.name.startswith("_") or sub.name == "__call__"):
                    out.add(f"{node.name}.{sub.name}")
    return out


def _defined(path: Path) -> set:
    """Every name a module binds at top level (definitions, assignments,
    imports) and every attribute its classes define (methods, properties,
    fields), as `name` / `Class.attr`."""
    if not path.exists():
        return set()
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        out.add(f"{node.name}.{sub.name}")
                    elif isinstance(sub, ast.AnnAssign) and isinstance(sub.target, ast.Name):
                        out.add(f"{node.name}.{sub.target.id}")
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update(a.asname or a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return out


def _modules() -> list:
    return sorted(p.relative_to(JAX_PKG).as_posix() for p in JAX_PKG.rglob("*.py"))


def _resolves(target: str) -> bool:
    mod, name = target.split(":")
    return name in _defined(PORT / mod)


@pytest.mark.parametrize("module", _modules())
def test_every_public_name_has_a_counterpart(module):
    port_names = _defined(PORT / module)
    mapped = COUNTERPARTS.get(module, {})
    reasons = NO_COUNTERPART.get(module, {})
    missing = []
    for name in sorted(_public_names(JAX_PKG / module)):
        if name in port_names or name in reasons:
            continue
        if name in mapped and _resolves(mapped[name]):
            continue
        missing.append(name)
    assert not missing, f"{module}: no counterpart in {PORT.name}/{module} for {missing}"


def test_tables_name_real_gaps():
    """Every entry of the two tables names a name the JAX module defines and
    its port module does not; a mapped counterpart exists; a reason is one
    line of text."""
    for table in (COUNTERPARTS, NO_COUNTERPART):
        for module, names in table.items():
            jax_names = _defined(JAX_PKG / module)
            port_names = _defined(PORT / module)
            for name, value in names.items():
                assert name in jax_names, f"{module}:{name} is not in the JAX package"
                assert name not in port_names, f"{module}:{name} is in the port: drop the entry"
                assert value and "\n" not in value
    for module, names in COUNTERPARTS.items():
        for name, target in names.items():
            assert _resolves(target), f"{module}:{name} -> {target} does not exist"


@pytest.mark.parametrize("module", sorted(COMPILED))
def test_compiled_programs_have_graphs(module):
    """Each program the JAX package jits as one device program per call
    (the jit where the JAX module has it, right before the program's `def`
    or around its returned step) has a captured CUDA graph in the port."""
    source = (JAX_PKG / module).read_text()
    for name, (jit, target) in COMPILED[module].items():
        assert jit in source, f"{module}: no `{jit}` for {name}"
        assert name in _defined(JAX_PKG / module)
        assert _resolves(target), f"{module}:{name} -> {target} does not exist"


def _example_names() -> list:
    return sorted(p.name for p in EXAMPLES.glob("*.py") if not p.name.startswith("torch_"))


@pytest.mark.parametrize("example", _example_names())
def test_every_example_has_a_twin(example):
    """Each JAX example has its `examples/torch_<name>` twin, or a reason in
    `NO_TWIN`, and never both."""
    twin = (EXAMPLES / f"torch_{example}").exists()
    if example in NO_TWIN:
        assert not twin, f"examples/{example} has a twin: drop its NO_TWIN entry"
        assert NO_TWIN[example] and "\n" not in NO_TWIN[example]
        return
    assert twin, f"examples/{example} has no torch_ twin"


def test_no_twin_names_real_examples():
    """Every `NO_TWIN` entry names a JAX example of the repo, and every
    twin it points to exists."""
    for example, reason in NO_TWIN.items():
        assert (EXAMPLES / example).exists(), f"examples/{example} does not exist"
        for word in reason.replace(",", " ").replace(";", " ").replace("(", " ").split():
            if word.startswith("torch_") and word.endswith(".py"):
                assert (EXAMPLES / word).exists(), f"{example}: {word} does not exist"


def test_bench_has_its_twin():
    """The repo's headline benchmark `bench.py` has its twin `torch_bench.py`
    beside it."""
    assert (REPO / "bench.py").exists() and (REPO / "torch_bench.py").exists()


def test_port_and_twins_import_no_jax():
    """No module of the port, no twin and not `torch_bench.py` names jax,
    flax, optax or the JAX package in an import statement."""
    banned = ("jax", "flax", "optax", "densemonoslam_tpu")
    for path in [*PORT.rglob("*.py"), *EXAMPLES.glob("torch_*.py"), REPO / "torch_bench.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path.relative_to(REPO)} imports {name}"
