"""Import hygiene of the port: lvdgs_torch and chip_smoke.py never import
JAX, Flax or the reference package, and importing every module of the port
needs neither a GPU nor the CUDA toolkit."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lvdgs_tpu")
SOURCES = sorted((ROOT / "lvdgs_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_imports(path):
    bad = [(line, mod) for line, mod in _imported_modules(path) if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_module_imports_without_gpu_or_nvcc():
    code = (
        "import importlib, pkgutil, sys\n"
        "import lvdgs_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(lvdgs_torch.__path__, 'lvdgs_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "missing = {'lvdgs_torch.io.checkpoint', 'lvdgs_torch.perception.masking',\n"
        "           'lvdgs_torch.perception.oracle', 'lvdgs_torch.perception.dynamic_filter',\n"
        "           'lvdgs_torch.models.mast3r.vit', 'lvdgs_torch.models.mast3r.dpt',\n"
        "           'lvdgs_torch.models.mast3r.model', 'lvdgs_torch.models.mast3r.matching',\n"
        "           'lvdgs_torch.models.mast3r.inference', 'lvdgs_torch.models.mast3r.oracle',\n"
        "           'lvdgs_torch.ops.msda', 'lvdgs_torch.models.groundingdino.swin',\n"
        "           'lvdgs_torch.models.groundingdino.bert', 'lvdgs_torch.models.groundingdino.model',\n"
        "           'lvdgs_torch.models.groundingdino.convert', 'lvdgs_torch.models.groundingdino.inference',\n"
        "           'lvdgs_torch.models.sam.model', 'lvdgs_torch.models.sam.convert',\n"
        "           'lvdgs_torch.models.sam.inference', 'lvdgs_torch.models.mast3r.cloud_opt',\n"
        "           'lvdgs_torch.models.mast3r.coarse_to_fine', 'lvdgs_torch.models.dinov2.model',\n"
        "           'lvdgs_torch.eval.viz', 'lvdgs_torch.gui.gui_utils', 'lvdgs_torch.io.colmap',\n"
        "           'lvdgs_torch.tools.colmap_export', 'lvdgs_torch.tools.batch_detect',\n"
        "           'lvdgs_torch.tools.semantic_label', 'lvdgs_torch.tools.dinov2_analyze',\n"
        "           'lvdgs_torch.tools.sam_setup', 'lvdgs_torch.tools.gen_prompt_vocab',\n"
        "           'lvdgs_torch.parallel.mesh', 'lvdgs_torch.parallel.collectives',\n"
        "           'lvdgs_torch.parallel.launch', 'lvdgs_torch.parallel.dp_mapping'} - set(names)\n"
        "assert not missing, missing\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "assert not bad, bad\n"
        "import torch; assert not torch.cuda.is_available()\n"
        "print(len(names))\n" % (FORBIDDEN,)
    )
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "PYTHONPATH")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PATH"] = os.path.dirname(sys.executable)  # no nvcc on the path
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 74


def test_packaged_vocab_is_the_ports_own_copy():
    """The tokenizer's packaged prompt-lexicon vocab lies in lvdgs_torch, a
    byte-for-byte copy of the reference's asset."""
    from lvdgs_torch.models.groundingdino import inference

    ours = Path(inference._PACKAGED_VOCAB)
    assert ours.is_file() and ours.resolve().is_relative_to(ROOT / "lvdgs_torch")
    ref = ROOT / "lvdgs_tpu" / "models" / "groundingdino" / "assets" / "prompt_vocab.txt"
    assert ours.read_bytes() == ref.read_bytes()


def test_kernel_sources_are_in_the_package():
    from lvdgs_torch.ops import rasterizer_cuda as rc

    blend = "__global__ void __launch_bounds__(NPIX)\n"
    kernels = {
        "blend.cu": ((blend + "blend_fwd_kernel", blend + "blend_bwd_kernel",
                      blend + "median_depth_kernel"),
                     ("lvdgs_blend_fwd", "lvdgs_blend_bwd", "lvdgs_median_depth")),
        "blend_packed.cu": (("template <bool BF16, int MODE>\n" + blend + "packed_fwd_kernel",
                             "template <bool BF16>\n" + blend + "packed_bwd_kernel"),
                            ("lvdgs_packed_fwd", "lvdgs_packed_bwd", "lvdgs_packed_fwd_bf16",
                             "lvdgs_packed_bwd_bf16")),
        "resident.cu": (("__global__ void __launch_bounds__(32)\nresident_gather_kernel",
                         "__global__ void __launch_bounds__(SB)\nresident_scatter_kernel"),
                        ("lvdgs_resident_gather", "lvdgs_resident_scatter", "lvdgs_resident_scatter_add")),
    }
    assert set(rc._SOURCES) == {name[:-3] for name in kernels}
    for name, (globals_, entry_points) in kernels.items():
        src = (ROOT / "lvdgs_torch" / "csrc" / name).read_text()
        if name != "resident.cu":
            assert '#include "blend_common.cuh"' in src
        for kernel in globals_:
            assert f"{kernel}(" in src
        for fn in entry_points:
            assert f"int {fn}(" in src
    # the measurement entry point is a module of the package
    assert (ROOT / "lvdgs_torch" / "tools" / "perf_resident.py").is_file()
    assert (ROOT / "lvdgs_torch" / "tools" / "__init__.py").is_file()
