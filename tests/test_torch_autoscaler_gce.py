"""The port's twins of tests/test_autoscaler_gce.py: VM-atomic autoscaling
against a fake GCE API.

The reference scales whole TPU slices (`GceTpuNodeProvider`, a
v5litepod-16 is 4 hosts x 4 chips); the port scales whole Compute Engine A3
VMs with their H100s (`GceGpuNodeProvider`, an a3-highgpu-8g is one host
with 8). Each twin runs its scenario on each package's own provider and
session, and compares launched and terminated counts, created types and
scoping. Then one port-only check end to end: the autoscaler launches a VM
through the REST client over a fake Compute API whose insert runs the
startup script the client built; the port's agent it starts joins as
``<name>-w0``, a pending GPU actor lands there, and the drained VM's
delete leaves no process.
"""

from __future__ import annotations

import glob
import os
import sys
import time

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's unit of scaling and the port's, by twin
UNIT = {"ray_tpu": "v5litepod-16", "ray_tpu_torch": "a3-highgpu-8g"}


def _port(rt) -> bool:
    return rt.__name__ == "ray_tpu_torch"


def _gce(rt):
    """(fake API class, provider class, node type factory) of `rt`."""
    if _port(rt):
        from ray_tpu_torch.autoscaler import (FakeGceGpuApi,
                                              GceGpuNodeProvider,
                                              gpu_vm_node_type)

        return FakeGceGpuApi, GceGpuNodeProvider, gpu_vm_node_type
    from ray_tpu.autoscaler import (FakeGceTpuApi, GceTpuNodeProvider,
                                    tpu_slice_node_type)

    return FakeGceTpuApi, GceTpuNodeProvider, tpu_slice_node_type


def _node_type(rt, max_nodes: int):
    _, _, make = _gce(rt)
    if _port(rt):
        return make(UNIT[rt.__name__], cpus=8, max_nodes=max_nodes)
    return make(UNIT[rt.__name__], cpus_per_host=8, max_nodes=max_nodes)


def _labels(rt):
    key = "machine_type" if _port(rt) else "accelerator_type"
    return {key: UNIT[rt.__name__]}


def _both(scenario):
    """scenario(ray_tpu), then scenario(ray_tpu_torch); both must agree."""
    import ray_tpu
    import ray_tpu_torch

    a, b = scenario(ray_tpu), scenario(ray_tpu_torch)
    assert a == b, (a, b)
    return a


@pytest.fixture
def sessions():
    """Both runtimes, fresh, per test (the reference's per-test session);
    the port's head has no GPU."""
    import ray_tpu
    import ray_tpu_torch

    for rt in (ray_tpu, ray_tpu_torch):
        rt.shutdown()
        rt.init(num_cpus=2, num_workers=1, max_workers=4,
                **({"num_gpus": 0} if _port(rt) else {}))
    yield
    for rt in (ray_tpu, ray_tpu_torch):
        rt.shutdown()


def _mk(rt, provider, types, **kw):
    # drain grace 0: these tests assert same-pass scale-down
    from importlib import import_module

    api = import_module(f"{rt.__name__}._private.api")
    Autoscaler = import_module(f"{rt.__name__}.autoscaler").Autoscaler
    return Autoscaler(f"unix:{api._node.socket_path}", provider, types,
                      idle_timeout_s=kw.pop("idle_timeout_s", 0.2),
                      drain_grace_s=kw.pop("drain_grace_s", 0.0), **kw)


def _pg(rt):
    from importlib import import_module

    return import_module(f"{rt.__name__}.util.placement_group")


def test_slice_shapes_and_node_type():
    from ray_tpu.autoscaler.gce_tpu import slice_shape
    from ray_tpu_torch.autoscaler.gce_gpu import machine_shape

    assert slice_shape("v5litepod-16") == (16, 4)
    assert slice_shape("v4-8") == (4, 1)
    assert machine_shape("a3-highgpu-8g") == (8, 208)
    assert machine_shape("a3-highgpu-1g") == (1, 26)
    assert machine_shape("a3-megagpu-8g") == (8, 208)
    assert machine_shape("a3-edgegpu-8g") == (8, 208)
    # no parse of a trailing -<n>g: those types carry other cards and
    # other vCPU counts (A100s at 12 vCPUs each, H200s)
    for other in ("n2-standard-8", "a2-highgpu-1g", "a3-ultragpu-8g"):
        with pytest.raises(ValueError, match="unknown machine_type"):
            machine_shape(other)

    def scn(rt):
        nt = _node_type(rt, 4)
        acc = "GPU" if _port(rt) else "TPU"
        heads = sorted(k for k in nt.resources if k.endswith("-head"))
        return (nt.name == f"{acc.lower()}-{UNIT[rt.__name__]}",
                nt.labels["ray.io/node-group"] == nt.name,
                nt.resources[acc] / (16.0 if acc == "TPU" else 8.0),
                (nt.min_nodes, nt.max_nodes), len(heads))

    # a multi-host slice needs its head resource; a VM is one host
    ref = scn(__import__("ray_tpu"))
    port = scn(__import__("ray_tpu_torch"))
    assert ref[:4] == port[:4] == (True, True, 1.0, (0, 4))
    assert (ref[4], port[4]) == (1, 0)
    port_nt = _node_type(__import__("ray_tpu_torch"), 4)
    assert port_nt.resources == {"GPU": 8.0, "CPU": 8.0}
    assert port_nt.labels["accelerator_type"] == "nvidia-h100-80gb"
    from ray_tpu_torch.autoscaler import gpu_vm_node_type

    assert gpu_vm_node_type("a3-highgpu-2g").resources == {"GPU": 2.0,
                                                           "CPU": 52.0}


def test_fake_api_provisioning_states():
    def scn(rt):
        Fake, Provider, _ = _gce(rt)
        api = Fake(provision_delay_s=0.2)
        prov = Provider(api)
        nid = prov.create_node(_node_type(rt, 4).name, {}, _labels(rt))
        out = [prov.is_ready(nid)]          # CREATING
        time.sleep(0.25)
        out.append(prov.is_ready(nid))      # READY
        out.append(prov.describe_node(nid) == _labels(rt))
        prov.terminate_node(nid)
        out.append(prov.non_terminated_nodes())
        out.append([c[0] for c in api.calls])
        out.append(api.calls[0][2] == UNIT[rt.__name__])
        return out

    assert _both(scn) == [False, True, True, [], ["create", "delete"], True]


def test_owns_node_scoped_by_cluster_name():
    """Two clusters sharing a project/zone must not sweep each other's
    nodes: cluster_name scopes both the created names and owns_node."""
    def scn(rt):
        Fake, Provider, _ = _gce(rt)
        prov = Provider(Fake(), cluster_name="blue")
        tname = _node_type(rt, 4).name
        nid = prov.create_node(tname, {}, _labels(rt))
        out = [nid.startswith(f"ray--blue--{tname}-"), prov.owns_node(nid),
               prov.owns_node(f"ray--green--{tname}-abc123"),  # other cluster
               prov.owns_node("my-manual-vm"),                 # operator's
               # hyphenated names must not prefix-collide: "blue"/"blue-eu"
               prov.owns_node(f"ray--blue-eu--{tname}-abc123")]
        for bad in ("bad--name", "trailing-"):
            with pytest.raises(ValueError, match="--"):
                Provider(Fake(), cluster_name=bad)
        # an UNSCOPED provider can't tell its own ray-* nodes from another
        # cluster's ray-<name>-* — it never claims sweep rights at all
        default = Provider(Fake())
        out += [default.owns_node(f"ray-{tname}-abc123"),
                default.owns_node("my-manual-vm")]
        # joined-ness: "<name>-w" prefix, so node 1 never matches node 10's
        out += [prov.node_joined(nid, [f"{nid}-w0"]),
                prov.node_joined(f"{nid}1", [f"{nid}10-w0"]),
                prov.node_joined(nid, [nid])]
        # a restarted provider re-adopts a live node, and not a gone one
        fresh = Provider(prov.api, cluster_name="blue")
        out += [fresh.adopt_node(nid, prov.describe_node(nid)),
                fresh.describe_node(nid) == prov.describe_node(nid),
                fresh.adopt_node(f"{nid}x", {})]
        return out

    assert _both(scn) == [True, True, False, False, False, False, False,
                          True, False, False, True, True, False]


def test_pg_demand_scales_slice_up_and_down(sessions):
    """A pending placement group worth one unit launches exactly ONE whole
    unit (a v5e-16 slice; an a3-highgpu-8g VM for 8 packed 1-GPU bundles);
    draining the demand terminates it."""
    def scn(rt):
        Fake, Provider, _ = _gce(rt)
        api = Fake()
        provider = Provider(api, gcs_address="unused")
        # grace 0: the fake node never joins the GCS, and this test wants
        # the idle clock running from the first post-drain pass
        a = _mk(rt, provider, [_node_type(rt, 2)], node_startup_grace_s=0.0)
        pgm = _pg(rt)
        if _port(rt):
            pg = pgm.placement_group([{"GPU": 1.0} for _ in range(8)],
                                     strategy="PACK")
        else:
            # 4 hosts x 4 chips + the slice-head sentinel
            pg = pgm.placement_group(
                [{"TPU": 4.0} for _ in range(4)]
                + [{"TPU-v5litepod-16-head": 1.0}], strategy="SPREAD")
        time.sleep(0.3)  # the PG becomes pending demand at the GCS
        actions = a.reconcile_once()
        out = [len(actions["launched"]), len(api.list_nodes()),
               api.calls[0][2] == UNIT[rt.__name__]]
        # demand drains → the unit is released whole after the idle timeout
        pgm.remove_placement_group(pg)
        time.sleep(0.3)
        a.reconcile_once()          # idle clock starts
        time.sleep(0.25)
        actions = a.reconcile_once()
        out += [len(actions["terminated"]), api.list_nodes()]
        a.stop(terminate_nodes=False)
        return out

    assert _both(scn) == [1, 1, True, 1, []]


def test_slice_never_partially_scaled(sessions):
    """Demand for half a unit still allocates a whole unit; demand for two
    units' worth allocates two."""
    def scn(rt):
        Fake, Provider, _ = _gce(rt)
        api = Fake()
        a = _mk(rt, Provider(api), [_node_type(rt, 4)])
        pgm = _pg(rt)
        acc, n = ("GPU", 8.0) if _port(rt) else ("TPU", 16.0)
        # half a unit: 4 x 1 GPU of 8; 2 hosts x 4 chips of 16
        half = ([{"GPU": 1.0}] * 4 if _port(rt)
                else [{"TPU": 4.0} for _ in range(2)])
        pg1 = pgm.placement_group(half)
        time.sleep(0.3)
        out = [len(a.reconcile_once()["launched"])]  # whole unit, not hosts
        pg2 = pgm.placement_group([{acc: n}, {acc: n}])  # two more units
        time.sleep(0.3)
        out.append(len(a.reconcile_once()["launched"]))
        out.append(len(api.list_nodes()))
        out.append(sorted({c[2] for c in api.calls if c[0] == "create"})
                   == [UNIT[rt.__name__]])
        pgm.remove_placement_group(pg1)
        pgm.remove_placement_group(pg2)
        a.stop(terminate_nodes=False)
        return out

    assert _both(scn) == [1, 2, 3, True]


# -- the port's own: a VM launched through the REST client ----------------


def _group_members(pgid: int) -> list:
    """Live (not zombie) processes of process group `pgid`."""
    out = []
    for p in os.listdir("/proc"):
        if not p.isdigit():
            continue
        try:
            with open(f"/proc/{p}/stat", "rb") as f:
                fields = f.read().rsplit(b")", 1)[1].split()
        except OSError:
            continue
        if int(fields[2]) == pgid and fields[0] != b"Z":
            out.append(int(p))
    return out


def test_vm_launched_through_the_rest_client_runs_a_gpu_actor(monkeypatch,
                                                              tmp_path):
    import ray_tpu_torch
    from ray_tpu_torch._private import api as _api
    from ray_tpu_torch.autoscaler import (Autoscaler, GceGpuNodeProvider,
                                          gpu_vm_node_type)
    from ray_tpu_torch.autoscaler.gce_rest import RestGceGpuApi

    # chip_smoke.py's phase 20c runs this same fake Compute API on the card
    sys.path.insert(0, HERE)
    try:
        import chip_smoke
    finally:
        sys.path.remove(HERE)
    bin_dir = str(tmp_path / "bin")
    chip_smoke.python_on_path(bin_dir)
    monkeypatch.setenv("RAY_TPU_TORCH_GPUS", "1")  # the VM's card
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
    ray_tpu_torch.shutdown()
    info = ray_tpu_torch.init(num_cpus=2, num_gpus=0, num_workers=0,
                              max_workers=4)
    sid = info["session_id"]
    node = _api._node
    cloud = chip_smoke.FakeCompute(bin_dir, str(tmp_path))
    rest = RestGceGpuApi(chip_smoke.GCE_PROJECT, chip_smoke.GCE_ZONE,
                         transport=cloud, source_image=chip_smoke.GCE_IMAGE,
                         token_provider=lambda: "token",
                         gcs_address=node.address, op_poll_s=0.0)
    prov = GceGpuNodeProvider(rest, cluster_name="t")
    a = Autoscaler(f"unix:{node.socket_path}", prov,
                   [gpu_vm_node_type("a3-highgpu-1g", cpus=1, max_nodes=1)],
                   interval_s=0.2, idle_timeout_s=0.5,
                   drain_grace_s=0.0).start()
    try:
        @ray_tpu_torch.remote(num_gpus=1)
        class OnVm:
            def where(self):
                import os

                return (os.environ.get("RAY_TPU_TORCH_HOST_ID"),
                        os.environ.get("CUDA_VISIBLE_DEVICES"))

        actor = OnVm.remote()
        host, visible = ray_tpu_torch.get(actor.where.remote(), timeout=120)
        vm, = cloud.vms
        assert vm.startswith("ray--t--gpu-a3-highgpu-1g-")
        assert (host, visible) == (f"{vm}-w0", "0")
        pid = cloud.vms[vm].pid
        ray_tpu_torch.kill(actor)
        deadline = time.monotonic() + 60
        while cloud.vms and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not cloud.vms, "the idle VM was not deleted"
        # no process of the VM's group is left (zombies aside: the agent
        # and its workers are reparented when bash goes)
        deadline = time.monotonic() + 10
        while _group_members(pid) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not _group_members(pid)
    finally:
        a.stop()
        ray_tpu_torch.shutdown()
    assert not glob.glob(f"/dev/shm/rtpt_{sid}*")
    calls = [(m, path) for _, m, path in cloud.calls]
    methods = [m for m, _ in calls]
    assert methods[methods.index("POST") + 1] == "GET"  # the op poll
    assert ("GET", "operations/operation-1") in calls
    assert ("DELETE", f"instances/{vm}") in calls
    assert cloud.deleted.keys() == {vm}
    assert cloud.images == {vm: [chip_smoke.GCE_IMAGE]}
