"""The port's public names against the JAX package's (ROADMAP Queue 3 E).

Each subpackage's ``__all__`` equals the reference's but for one explicit
table of allowed differences: a reference name not ported yet, with the
ROADMAP.md Queue 1 item that ports it; a deliberate rename; or a name of
the port's own. An entry goes when its item lands.
"""

from __future__ import annotations

import importlib

import pytest

# the GCE TPU provider's names and the GCE GPU provider's
GCE_RENAMES = {"GceTpuApi": "GceGpuApi", "FakeGceTpuApi": "FakeGceGpuApi",
               "GceTpuNodeProvider": "GceGpuNodeProvider",
               "tpu_slice_node_type": "gpu_vm_node_type"}
# util.accelerators.tpu's names and util.accelerators.gpu's: a GCE GPU VM
# is one host, so the pod functions and the slice-head resource have none
ACCELERATOR_RENAMES = {
    "get_num_tpu_chips_on_node": "get_num_gpus_on_node",
    "get_current_process_visible_chip_ids":
        "get_current_process_visible_gpu_ids",
    "get_current_pod_name": None,
    "get_current_pod_worker_count": None,
    "slice_head_resource": None,
}

# package → {name: why it differs}. "item N": ROADMAP.md Queue 1 item N
# ports it; "rename": the port's name for it; "port": the port's own name
# (the reference has no counterpart, or keeps it outside __all__)
ALLOWED = {
    "": {
        "resolve_device": "port: the device entry points run on (cuda "
                          "unless the caller asks for the CPU)",
    },
    "llm": {
        "TPUEngine": "rename: LLMEngine",
        "LLMEngine": "rename of TPUEngine",
        "LoraConfig": "port: exported (the reference keeps it in "
                      "llm.config)",
    },
    "train": {
        "JaxConfig": "port: TorchConfig (gloo or nccl) is the backend",
        "JaxTrainer": "port: TorchTrainer is the trainer",
        **{n: "port: the optimizers the reference takes from optax"
           for n in ("AdamWInt8", "adamw", "adamw_int8",
                     "optimizer_state_bytes", "param_leaves")},
    },
    "tune": {},
    "autoscaler": {
        **{tpu: f"rename: {gpu} (one Compute Engine A3 VM per node, not a "
                "TPU slice)" for tpu, gpu in GCE_RENAMES.items()},
        **{gpu: f"rename of {tpu}" for tpu, gpu in GCE_RENAMES.items()},
    },
    "util.accelerators": {
        "tpu": "rename: gpu",
        "gpu": "rename of tpu",
    },
    "dag": {},
    "experimental.channel": {},
    "util.collective": {},
    "serve": {},
    "data": {},
    "util": {},
    "dashboard": {},
    "util.client": {},
    "util.multiprocessing": {},
    "util.dask": {},
    "parallel": {
        "shard_map": "port: explicit per-rank SPMD takes its place",
        **{n: "port: the DeviceMesh's axis names and helpers, which the "
              "reference takes from jax.sharding"
           for n in ("MESH_AXIS_DP", "MESH_AXIS_EP", "MESH_AXIS_FSDP",
                     "MESH_AXIS_PP", "MESH_AXIS_SP", "MESH_AXIS_TP",
                     "NamedSharding", "P", "PartitionSpec", "current_mesh",
                     "launch", "local_mesh_devices", "use_mesh")},
    },
    "models": {
        **{n: "port: submodules the reference keeps outside __all__"
           for n in ("convert", "decoding", "decoding_paged")},
    },
    # every name of the reference's rllib, DreamerV3 included
    "rllib": {},
    "ops": {
        "flash_attention": "port: the name is the kernel's submodule; the "
                           "function is FlashAttention / "
                           "flash_attention_backward",
        **{n: "port: the kernels' entry points and plain versions"
           for n in ("FlashAttention", "flash_attention_backward",
                     "kernel_fits", "reference_attention", "topk_routing")},
    },
}


def _all(pkg: str, sub: str) -> set:
    mod = importlib.import_module(f"{pkg}.{sub}" if sub else pkg)
    return set(mod.__all__)


@pytest.mark.parametrize("sub", sorted(ALLOWED))
def test_all_matches_the_reference_but_the_named_differences(sub):
    ref, port = _all("ray_tpu", sub), _all("ray_tpu_torch", sub)
    allowed = ALLOWED[sub]
    assert (ref ^ port) == set(allowed), (
        f"unlisted: {sorted((ref ^ port) - set(allowed))}, "
        f"stale: {sorted(set(allowed) - (ref ^ port))}")
    for name in port:  # every exported name resolves
        assert hasattr(importlib.import_module(
            f"ray_tpu_torch.{sub}" if sub else "ray_tpu_torch"), name), name


def test_accelerator_utilities_match_the_reference_but_the_pod_names():
    """util.accelerators.gpu's names are tpu's renamed, but for the pod
    functions and slice_head_resource: a GCE GPU VM is one host."""
    from ray_tpu.util.accelerators import tpu
    from ray_tpu_torch.util.accelerators import gpu

    assert set(tpu.__all__) == set(ACCELERATOR_RENAMES)
    assert set(gpu.__all__) == {g for g in ACCELERATOR_RENAMES.values() if g}
    for name in gpu.__all__:
        assert callable(getattr(gpu, name)), name


def test_queue3_e_names_are_exported():
    from ray_tpu_torch.llm import KVTransferError, PagedKVExporter
    from ray_tpu_torch.llm import kv_transfer
    from ray_tpu_torch.train import make_zero_train_step, \
        match_partition_rules
    from ray_tpu_torch.train import zero

    assert KVTransferError is kv_transfer.KVTransferError
    assert PagedKVExporter is kv_transfer.PagedKVExporter
    assert make_zero_train_step is zero.make_zero_train_step
    assert match_partition_rules is zero.match_partition_rules


# cluster_utils has no __all__: its Cluster's methods and their keyword
# arguments, with the port's renames and refusals
CLUSTER_RENAMES = {"num_tpus": "num_gpus"}


def test_cluster_utils_cluster_matches_the_reference_but_the_renames():
    import inspect

    from ray_tpu.cluster_utils import Cluster as Ref
    from ray_tpu_torch.cluster_utils import Cluster as Port

    def methods(cls):
        return {n for n, f in vars(cls).items()
                if callable(f) and not n.startswith("_")}

    assert methods(Ref) == methods(Port)
    for name in ("add_node", "remove_node", "shutdown"):
        ref = [CLUSTER_RENAMES.get(p, p) for p in
               inspect.signature(getattr(Ref, name)).parameters]
        port = list(inspect.signature(getattr(Port, name)).parameters)
        assert ref == port, (name, ref, port)
