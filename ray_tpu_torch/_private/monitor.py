"""Standalone monitor process: the autoscaler loop as its own OS process.

The port's copy of ray_tpu/_private/monitor.py, run as
``python -m ray_tpu_torch._private.monitor --address <GCS address>
--autoscaling-config <json or yaml> [--keep-nodes-on-exit]``. Its
providers are ``local`` (follower agents on this machine), ``gce_gpu``
(one Compute Engine A3 VM per node over compute.googleapis.com v1),
``kuberay``, and ``fake_gce_gpu``/``fake_file`` for tests; ``gce_tpu`` and
``fake_gce_tpu`` are refused by name.

(reference: python/ray/autoscaler/_private/monitor.py — the head node runs
`monitor.py` as a separate process that connects to the GCS, reads demand,
and drives the NodeProvider; the control plane never blocks on cloud API
calls. Here the same Autoscaler class the in-process tests use is hosted
behind a CLI entry.)

Config (JSON or YAML):
    provider:
      type: local | gce_gpu | kuberay        # fake_gce_gpu, fake_file for tests
      ... provider-specific keys ...
    node_types:
      worker: {resources: {CPU: 4}, min_nodes: 0, max_nodes: 10}
    idle_timeout_s: 60
    interval_s: 2
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import sys
import threading

logger = logging.getLogger(__name__)


def load_config(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except ValueError:
        import yaml

        return yaml.safe_load(text)


def build_provider(cfg: dict, gcs_address: str):
    p = dict(cfg.get("provider") or {"type": "local"})
    kind = p.pop("type", "local")
    if kind in ("gce_tpu", "fake_gce_tpu"):
        # one TPU slice per node over tpu.googleapis.com: a slice has no
        # GPU counterpart; the card's cloud provider is gce_gpu
        raise NotImplementedError(
            f"the {kind!r} provider (one TPU slice per node over "
            "tpu.googleapis.com) is left out by decision: use 'gce_gpu' "
            "(one Compute Engine A3 VM with its H100s per node) or "
            "'fake_gce_gpu'")
    if kind == "local":
        from ray_tpu_torch.autoscaler.node_provider import LocalNodeProvider

        return LocalNodeProvider(gcs_address)
    if kind == "gce_gpu":
        from ray_tpu_torch.autoscaler.gce_gpu import GceGpuNodeProvider
        from ray_tpu_torch.autoscaler.gce_rest import RestGceGpuApi

        # fail LOUDLY here, at monitor start — a missing project/zone/boot
        # image or unusable credentials must not wait for the first scale-up
        missing = [k for k in ("project", "zone", "source_image")
                   if not p.get(k)]
        if missing:
            raise ValueError(
                f"gce_gpu provider config is missing {missing}: the REST "
                "client cannot insert a VM on compute.googleapis.com "
                "without them (autoscaling-config provider: {type: "
                "gce_gpu, project: ..., zone: ..., source_image: <an image "
                "holding torch and this repository>})")
        api_kw = {k: p.pop(k) for k in ("network", "preemptible") if k in p}
        project, zone = p.pop("project"), p.pop("zone")
        api = RestGceGpuApi(project=project, zone=zone,
                            source_image=p.pop("source_image"),
                            gcs_address=gcs_address, **api_kw)
        api.validate()
        return GceGpuNodeProvider(api, project=project, zone=zone,
                                  gcs_address=gcs_address, **p)
    if kind == "fake_gce_gpu":
        from ray_tpu_torch.autoscaler.gce_gpu import (FakeGceGpuApi,
                                                      GceGpuNodeProvider)

        return GceGpuNodeProvider(FakeGceGpuApi(), **p)
    if kind == "fake_file":
        # file-backed fake "cloud" with SIGKILL fault injection — the
        # provider crash-restart chaos tests drive the real monitor process
        # through it (tests/test_autoscaler_chaos.py)
        from ray_tpu_torch.autoscaler.node_provider import (
            FakeFileNodeProvider)

        return FakeFileNodeProvider(
            p.pop("path"),
            die_after_create=int(p.pop("die_after_create", 0)))
    if kind == "kuberay":
        from ray_tpu_torch.autoscaler.kuberay import (KubeRayApiClient,
                                                      KubeRayNodeProvider)

        api = KubeRayApiClient(p.pop("namespace"), p.pop("cluster_name"),
                               **{k: p.pop(k) for k in ("api_server", "token")
                                  if k in p})
        return KubeRayNodeProvider(api, **p)
    raise ValueError(f"unknown provider type {kind!r}")


def build_node_types(cfg: dict):
    from ray_tpu_torch.autoscaler.autoscaler import NodeType

    out = []
    for name, spec in (cfg.get("node_types") or {}).items():
        out.append(NodeType(
            name=name, resources=dict(spec.get("resources") or {}),
            labels=dict(spec.get("labels") or {}),
            min_nodes=int(spec.get("min_nodes", 0)),
            max_nodes=int(spec.get("max_nodes", 10))))
    if not out:
        raise ValueError("autoscaling config has no node_types")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ray_tpu_torch monitor")
    ap.add_argument("--address", required=True,
                    help="GCS address host:port or unix:<path>")
    ap.add_argument("--autoscaling-config", required=True)
    ap.add_argument("--keep-nodes-on-exit", action="store_true",
                    help="leave provider nodes running when the monitor "
                         "process is stopped")
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s monitor %(levelname)s %(message)s")
    cfg = load_config(args.autoscaling_config)
    provider = build_provider(cfg, args.address)
    from ray_tpu_torch.autoscaler.autoscaler import Autoscaler

    scaler = Autoscaler(
        args.address, provider, build_node_types(cfg),
        interval_s=float(cfg.get("interval_s", 2.0)),
        idle_timeout_s=float(cfg.get("idle_timeout_s", 60.0)),
        node_startup_grace_s=float(cfg.get("node_startup_grace_s", 60.0)))
    stop = threading.Event()

    def _sig(_signum, _frame):
        stop.set()

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    logger.info("monitor up: %s provider, %d node types",
                type(provider).__name__, len(scaler.node_types))
    from ray_tpu_torch._private.protocol import ConnectionClosed

    while not stop.is_set():
        try:
            scaler.reconcile_once()
            # this process's registry (transition counter, reconcile
            # histogram, node gauges) reaches the GCS after each pass
            scaler._flush_metrics()
        except ConnectionClosed:
            # the head/GCS is gone: exit instead of looping forever as an
            # orphan keeping cloud nodes alive against a dead cluster
            logger.warning("GCS connection closed; monitor exiting")
            break
        except Exception:
            logger.exception("reconcile failed")
        stop.wait(scaler.interval_s)
    scaler.stop(terminate_nodes=not args.keep_nodes_on_exit)
    logger.info("monitor stopped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
