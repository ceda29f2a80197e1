"""What the benchmark loads, checked in fresh processes by top-level module
name (the part before the first dot, compared whole: the port's name
begins with the JAX package's)."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _top_levels_after(code: str) -> set[str]:
    probe = code + "\nimport json, sys\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, cwd=ROOT, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_harness_and_the_window_load_no_jax():
    loaded = _top_levels_after(
        "import runpy; runpy.run_path('portbench/run.py', run_name='not_main')\n"
        "from portbench import harness, control, reference, roofline, streams, trace, gen_rndm\n"
        "for p in sorted(harness.BENCH_DIR.glob('metrics/*.py')): harness.load_reader(p.stem)\n"
        "import vk_merkle_roots_tpu_torch._build, vk_merkle_roots_tpu_torch.ingest\n"
        "import vk_merkle_roots_tpu_torch.models.registry, vk_merkle_roots_tpu_torch.models.cuda\n"
        "harness.engine_config({'slice_log2': 20})\n")
    assert "vk_merkle_roots_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "vk_merkle_roots_tpu"}


def test_reference_and_generator_pull_in_nothing_of_the_port():
    loaded = _top_levels_after("from portbench import reference, gen_rndm")
    assert not loaded & {"vk_merkle_roots_tpu_torch", "vk_merkle_roots_tpu", "jax", "torch"}


def test_forbidden_modules_compare_whole_top_level_names():
    from portbench import harness

    sys.modules.setdefault("vk_merkle_roots_tpu_torch_probe", sys)
    try:
        assert "vk_merkle_roots_tpu" not in harness.forbidden_modules()
    finally:
        del sys.modules["vk_merkle_roots_tpu_torch_probe"]
