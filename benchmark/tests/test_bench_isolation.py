"""No file of the benchmark imports JAX or the JAX package, the plain
reference imports nothing of the port, and a run refuses a process that
holds any of them (top-level names compared whole)."""

import os

from conftest import BENCH
from harness import isolation


def _sources():
    for root, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_file_imports_jax_or_the_jax_package():
    found = list(_sources())
    assert len(found) > 20
    for path in found:
        in_ref = os.sep + "reference" + os.sep in path
        assert isolation.violations(path, in_ref) == [], path


def test_top_level_names_compare_whole():
    mods = ["nanopolish_tpu_torch", "nanopolish_tpu_torch.ops", "numpy",
            "jaxtyping"]
    assert isolation.forbidden_loaded(mods) == []
    for bad in ("jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                "nanopolish_tpu", "nanopolish_tpu.ops.profile_hmm"):
        assert isolation.forbidden_loaded(mods + [bad]) == [bad]


def test_import_scan_sees_every_form():
    src = ("import jax.numpy as jnp\nfrom nanopolish_tpu.ops import x\n"
           "import nanopolish_tpu_torch\nfrom . import local\n"
           "importlib.import_module('jaxlib')\n")
    assert isolation.imports_of(src) == ["jax", "nanopolish_tpu",
                                         "nanopolish_tpu_torch", "jaxlib"]
