"""The port stands alone: it imports neither JAX, nor the JAX package, nor
``ml_dtypes`` (which the machine with the card does not have)."""
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|repro|ml_dtypes)\b")


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch.launch.serve, repro_torch.convert, "
        "repro_torch.testing, repro_torch.checkpoint, "
        "repro_torch.kernels.ops, repro_torch.kernels.ref, "
        "repro_torch.kernels.pdist, repro_torch.kernels.zen, "
        "repro_torch.kernels.jsd, repro_torch.core.pivots, "
        "repro_torch.core.baselines, repro_torch.core.reducers, "
        "repro_torch.core.quality, repro_torch.data.synthetic, "
        "repro_torch.serving, repro_torch.distributed.fault, "
        "repro_torch.distributed.mesh, repro_torch.distributed.retrieval, "
        "repro_torch.launch.replicate, repro_torch.data.pipeline, "
        "repro_torch.models.recsys, repro_torch.configs, "
        "repro_torch.optim, repro_torch.checkpoint.checkpoint, "
        "repro_torch.launch.train, repro_torch.launch.train_lm, "
        "repro_torch.models.layers, repro_torch.models.moe, "
        "repro_torch.models.transformer, repro_torch.models.mace, "
        "repro_torch.data.graph, repro_torch.configs.mace, "
        "repro_torch.launch.model_flops, "
        "repro_torch.distributed.sharding, "
        "repro_torch.distributed.partition, repro_torch.launch.mesh, "
        "repro_torch.launch.steps\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", ["src/repro_torch", "chip_smoke.py"])
def test_no_source_line_imports_jax_or_repro(path):
    full = os.path.join(ROOT, path)
    files = [full] if full.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(full) for f in fs
        if f.endswith(".py")]
    assert files
    for f in files:
        with open(f) as fh:
            for n, line in enumerate(fh, 1):
                assert not _IMPORT.match(line), f"{f}:{n}: {line.strip()}"
