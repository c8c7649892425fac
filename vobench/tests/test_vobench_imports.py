"""What a run imports: no module whose top-level name (the part before the
first dot, compared whole) is jax or vo_tpu; and the reference imports
nothing of the program either."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BANNED = {"jax", "jaxlib", "flax", "vo_tpu"}


def _modules(package: str) -> list[str]:
    base = REPO / package.replace(".", "/")
    out = []
    for p in sorted(base.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        if "tests" in rel.parts:
            continue
        name = ".".join(rel.parts)
        out.append(name[: -len(".__init__")] if name.endswith("__init__")
                   else name)
    return out


def _loaded_after(imports: list[str], extra: str = "") -> set[str]:
    """Top-level names in sys.modules of a fresh interpreter after the
    imports (and `extra` code)."""
    code = ("import importlib, json, sys\n"
            f"for m in {imports!r}: importlib.import_module(m)\n"
            f"{extra}\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    mods = _modules("vobench")
    assert "vobench.run" in mods and "vobench.worker" in mods
    # what a worker and the parent import at run time, and every reader
    extra = ("from vobench import spec, worker\n"
             "import vo_tpu_torch._build, vo_tpu_torch.runtime.presets\n"
             "from vo_tpu_torch.ops import lk_cuda, blur_cuda, crop_cuda, "
             "rowconv_cuda\n"
             "b = json.load(open('BENCHMARK.json'))\n"
             "from pathlib import Path\n"
             "for m in b['per_layer']: spec.load_metric(Path('.'), m['name'])")
    loaded = _loaded_after(mods, extra)
    assert "vo_tpu_torch" in loaded and "vobench" in loaded
    assert not loaded & BANNED, loaded & BANNED
    # the program's name begins with the JAX package's: compared whole
    assert "vo_tpu" not in loaded


def test_the_reference_imports_nothing_of_the_program():
    mods = _modules("vobench.reference")
    assert "vobench.reference.step" in mods
    loaded = _loaded_after(mods)
    assert not loaded & (BANNED | {"vo_tpu_torch"}), loaded
