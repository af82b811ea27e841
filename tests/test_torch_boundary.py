"""The PyTorch port's import boundary and its copies of JAX-package helpers.

The port must import neither jax nor yaml (the GPU deployment carries
neither), so it keeps its own copies of both pipelines' config dataclasses and
of the numpy Farnebäck helpers; these tests hold the copies equal to the
originals (the scene and frame generators' copies: ``test_torch_sim.py``).
``chip_smoke.py`` imports nothing of the JAX side either.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from datmo_using_optical_flow_tpu import config as jcfg
from datmo_using_optical_flow_tpu.oracle import np_farneback as jnp_fb
from datmo_using_optical_flow_tpu_torch import config as tcfg
from datmo_using_optical_flow_tpu_torch.oracle import np_farneback as tnp_fb

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the GMFA step's modules, named so that a missing one fails the import check
_GMFA_MODULES = ("ops.points", "ops.nn_kernels", "ops.nn", "ops.icp", "ops.hungarian",
                 "ops.som", "ops.dbscan", "models.gmfa", "utils.ordered", "utils.state",
                 "utils.tree")
# this slice's kernels and the diagnostics that run them
_DIAGNOSTIC_MODULES = ("ops.probe_kernels", "diagnostics.roofline", "diagnostics.measure",
                       "diagnostics.micro_flow", "diagnostics.profile_1080p",
                       "diagnostics.icp_body")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import datmo_using_optical_flow_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
names += [pkg.__name__ + "." + m for m in %r]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "yaml", "datmo_using_optical_flow_tpu"))
print(len(set(names)), bad)
""" % (_GMFA_MODULES + _DIAGNOSTIC_MODULES,)


def test_port_imports_no_jax_and_no_yaml():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=_REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.strip().split(" ", 1)
    assert int(count) >= 37, proc.stdout  # every module of the port was imported
    assert bad == "[]", bad


_JAX_SIDE = ("jax", "jaxlib", "datmo_using_optical_flow_tpu", "bench")


def test_chip_smoke_imports_nothing_of_the_jax_side():
    """chip_smoke.py, read as source: no import of jax, of the JAX package or
    of its benchmark script, and no module loaded by file path."""
    with open(os.path.join(_REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            imported.append(node.module or "")
    assert "datmo_using_optical_flow_tpu_torch.sim" in imported  # the walk sees imports
    bad = sorted(m for m in imported if m.split(".")[0] in _JAX_SIDE)
    assert bad == [], bad
    names = {n.attr if isinstance(n, ast.Attribute) else n.id for n in ast.walk(tree)
             if isinstance(n, (ast.Attribute, ast.Name))}
    loaders = names & {"spec_from_file_location", "import_module", "__import__", "run_path"}
    assert not loaders, loaders


_CONFIG_CLASSES = ("RansacConfig", "FarnebackConfig", "MaskConfig", "DbscanConfig",
                   "CapacityConfig", "TrackerAConfig", "PipelineAConfig", "IcpConfig",
                   "SomConfig", "GMFAConfig")


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        else:
            out[f.name] = dataclasses.asdict(f.default_factory())
    return out


@pytest.mark.parametrize("name", _CONFIG_CLASSES)
def test_config_copy_matches_fields_and_defaults(name):
    jc, tc = getattr(jcfg, name), getattr(tcfg, name)
    assert [f.name for f in dataclasses.fields(tc)] == [f.name for f in dataclasses.fields(jc)]
    assert _defaults(tc) == _defaults(jc)
    assert dataclasses.asdict(tc()) == dataclasses.asdict(jc())


def test_config_copy_grid_shape_and_validation():
    for h, w in ((1080, 1920), (256, 320)):
        kw = dict(x_range=(0.0, h * 0.1), y_range=(0.0, w * 0.1), grid_resolution=(0.1, 0.1))
        assert tcfg.PipelineAConfig(**kw).grid_shape == jcfg.PipelineAConfig(**kw).grid_shape == (h, w)
    assert tcfg.PipelineAConfig().grid_shape == jcfg.PipelineAConfig().grid_shape
    assert tcfg.CapacityConfig().max_expanded_points == jcfg.CapacityConfig().max_expanded_points
    for mod in (tcfg, jcfg):
        mod.PipelineAConfig().validate()
        for bad in (dict(dt=0.0), dict(x_range=(1.0, 0.0)),
                    dict(farneback=mod.FarnebackConfig(winsize=4)),
                    dict(capacities=mod.CapacityConfig(max_cells=0))):
            with pytest.raises(ValueError, match="config validation failed"):
                mod.PipelineAConfig(**bad).validate()
        mod.GMFAConfig().validate()
        for bad in (dict(dt=0.0), dict(moving_threshold=0.1), dict(roi_bounds=(0.0,) * 5),
                    dict(icp=mod.IcpConfig(max_iterations=0)),
                    dict(som=mod.SomConfig(grid_size=0))):
            with pytest.raises(ValueError, match="config validation failed"):
                mod.GMFAConfig(**bad).validate()


def test_np_farneback_copies_are_identical():
    assert tnp_fb.BORDER == jnp_fb.BORDER
    assert tnp_fb.MIN_LEVEL_SIZE == jnp_fb.MIN_LEVEL_SIZE
    assert tnp_fb.BORDER_ATTEN.dtype == jnp_fb.BORDER_ATTEN.dtype
    np.testing.assert_array_equal(tnp_fb.BORDER_ATTEN, jnp_fb.BORDER_ATTEN)
    for args in ((1080, 1920, 0.3, 5), (256, 320, 0.3, 5), (64, 80, 0.5, 5), (31, 40, 0.3, 3)):
        assert tnp_fb.level_sizes(*args) == jnp_fb.level_sizes(*args)
    for n, sigma in ((5, 5.0), (7, 1.5), (5, 0.0)):
        for a, b in zip(tnp_fb.prepare_gaussian(n, sigma), jnp_fb.prepare_gaussian(n, sigma)):
            np.testing.assert_array_equal(a, b)
    for ksize, sigma in ((1, 0.0), (3, 0.0), (5, 0.0), (7, 0.0), (9, 0.0), (25, 5.06), (7, 1.1)):
        np.testing.assert_array_equal(tnp_fb.gaussian_kernel(ksize, sigma),
                                      jnp_fb.gaussian_kernel(ksize, sigma))
