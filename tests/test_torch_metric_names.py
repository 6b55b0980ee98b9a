"""The port's twins of tests/test_metric_names.py's two checks of a tree:
every Counter/Gauge/Histogram literal name in ray_tpu_torch matches the
one exported namespace (``ray_tpu_[a-z0-9_]+``, shared with the JAX
package, so dashboards read both), and the flagship exported families the
reference constructs are constructed in the port too."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import check_metric_names  # noqa: E402


def test_package_metric_names_are_canonical():
    bad = check_metric_names.check_tree(os.path.join(REPO, "ray_tpu_torch"))
    assert not bad, "\n".join(f"{p}:{ln}: {name!r}" for p, ln, name in bad)


def test_expected_exported_metrics_still_constructed():
    missing = check_metric_names.check_expected(
        os.path.join(REPO, "ray_tpu_torch"))
    assert not missing, f"expected metrics not constructed: {missing}"
