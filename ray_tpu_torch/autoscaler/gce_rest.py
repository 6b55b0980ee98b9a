"""REST client for Compute Engine (compute.googleapis.com v1): A3 VMs with
H100s as the autoscaler's nodes.

The port's counterpart of ray_tpu/autoscaler/gce_rest.py. It implements the
`GceGpuApi` surface the VM-atomic provider consumes (reference:
python/ray/autoscaler/_private/gcp/node.py GCPComputeNode wraps the same
API via googleapiclient). Built on urllib with an injectable transport so
every path — retries, backoff, quota/stockout/preemption mapping, operation
polling — is testable offline against canned responses; production uses
the default transport + the GCE metadata server for tokens.

Error model (surfaced to the autoscaler reconciler):
- `QuotaExceededError` — an HTTP error whose ``error.errors[].reason`` is
  ``quotaExceeded``/``rateLimitExceeded`` (or quota/rate wording), or a
  finished operation failing with ``QUOTA_EXCEEDED``: back off the node
  type; retrying immediately cannot succeed.
- `StockoutError` — a finished operation failing with
  ``ZONE_RESOURCE_POOL_EXHAUSTED[_WITH_DETAILS]``, RESOURCE_EXHAUSTED or "no
  available capacity" wording: back off the node type, ideally try another
  zone.
- `ComputeApiError` — anything else non-retryable (4xx).
Transient 5xx/429 responses and transport failures are retried here with
full-jitter exponential backoff before any error escapes.
"""

from __future__ import annotations

import json
import random
import shlex
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional

from ray_tpu_torch.autoscaler.gce_gpu import GceGpuApi
from ray_tpu_torch.autoscaler.node_provider import AGENT_MODULE

_BASE = "https://compute.googleapis.com/compute/v1"
_METADATA_TOKEN_URL = ("http://metadata.google.internal/computeMetadata/v1/"
                       "instance/service-accounts/default/token")

# instance statuses that mean "this VM is gone or going": a preempted VM
# ends TERMINATED, and it must drop out of non_terminated_nodes so the
# reconciler reaps and relaunches it
_TERMINAL_STATUSES = {"STOPPING", "SUSPENDING", "STOPPED", "SUSPENDED",
                      "TERMINATED"}
_CREATING_STATUSES = {"PROVISIONING", "STAGING", "REPAIRING"}

# error.errors[].reason of an HTTP error body (googleapis' usageLimits)
_QUOTA_REASONS = {"quotaExceeded", "rateLimitExceeded"}
# error.errors[].code of a finished operation
_QUOTA_CODES = {"QUOTA_EXCEEDED"}
_STOCKOUT_CODES = {"ZONE_RESOURCE_POOL_EXHAUSTED",
                   "ZONE_RESOURCE_POOL_EXHAUSTED_WITH_DETAILS"}


class ComputeApiError(Exception):
    """Non-retryable Compute API failure (final status + parsed message)."""

    def __init__(self, status: int, message: str):
        self.status = status
        self.message = message
        super().__init__(f"Compute API error {status}: {message}")


class QuotaExceededError(ComputeApiError):
    """Project quota exhausted — backoff, don't hot-retry."""

    cooldown_s = 120.0  # the reconciler backs off this node type


class StockoutError(ComputeApiError):
    """Zone has no capacity for this machine type right now."""

    cooldown_s = 30.0  # stockouts churn; re-probe sooner than quota


def _default_transport(method: str, url: str, headers: Dict[str, str],
                       body: Optional[bytes], timeout: float):
    """(status_code, body_bytes) via urllib; HTTP errors return their
    status instead of raising so the retry loop can classify them."""
    req = urllib.request.Request(url, data=body, headers=headers,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def metadata_token_provider() -> str:
    """Access token from the GCE metadata server (VMs with a service
    account). Off-GCP deployments inject their own provider."""
    status, body = _default_transport(
        "GET", _METADATA_TOKEN_URL, {"Metadata-Flavor": "Google"}, None, 5.0)
    if status != 200:
        raise ComputeApiError(status, "metadata server token fetch failed")
    return json.loads(body)["access_token"]


def _error_fields(body: bytes) -> tuple[str, str, set]:
    """(message, rpc status, {errors[].reason}) from an error envelope."""
    try:
        err = json.loads(body or b"{}").get("error") or {}
        reasons = {str(e.get("reason") or "") for e in err.get("errors") or ()
                   if isinstance(e, dict)}
        return (str(err.get("message") or ""), str(err.get("status") or ""),
                reasons - {""})
    except Exception:
        return (body or b"")[:200].decode("utf-8", "replace"), "", set()


def classify_error(status: int, body: bytes) -> ComputeApiError:
    """Map a final (post-retry) HTTP failure to the typed error the
    reconciler keys its backoff decisions on."""
    msg, rpc, reasons = _error_fields(body)
    low = msg.lower()
    if reasons & _QUOTA_REASONS:
        return QuotaExceededError(status, msg or "quota exceeded")
    if rpc == "RESOURCE_EXHAUSTED" or "no available capacity" in low \
            or "stockout" in low or "resources are insufficient" in low:
        # quota wording wins: quota problems persist, stockouts churn
        if "quota" not in low:
            return StockoutError(status, msg or "zone stockout")
    if status in (403, 429) and ("quota" in low or "rate limit" in low
                                 or rpc == "RESOURCE_EXHAUSTED"):
        return QuotaExceededError(status, msg or "quota exceeded")
    return ComputeApiError(status, msg or f"http {status}")


def classify_operation_error(op: dict) -> ComputeApiError:
    """Map a finished operation's ``error.errors[]`` to the typed error:
    QUOTA_EXCEEDED is quota, ZONE_RESOURCE_POOL_EXHAUSTED[_WITH_DETAILS] a
    stockout; any other code goes through the HTTP classification of its
    messages."""
    errors = [e for e in (op.get("error") or {}).get("errors") or ()
              if isinstance(e, dict)]
    codes = {str(e.get("code") or "") for e in errors}
    msg = "; ".join(str(e.get("message") or e.get("code") or "")
                    for e in errors)
    status = int(op.get("httpErrorStatusCode") or 400)
    if codes & _QUOTA_CODES:
        return QuotaExceededError(status, msg or "quota exceeded")
    if codes & _STOCKOUT_CODES:
        return StockoutError(status, msg or "zone stockout")
    return classify_error(status, json.dumps(
        {"error": {"message": msg}}).encode())


class RestGceGpuApi(GceGpuApi):
    """GceGpuApi over compute.googleapis.com v1
    ``instances.{insert,delete,list,get}`` and ``zoneOperations.get``.

    `source_image` is the VM's boot image and has no default: it must hold
    the card's driver, torch and this repository, for the startup script
    runs the port's node agent from it.

    `transport(method, url, headers, body, timeout) -> (status, bytes)` and
    `token_provider() -> str` are injectable; tests drive canned responses
    through exactly the code paths production takes.
    """

    RETRYABLE = {429, 500, 502, 503, 504}

    def __init__(self, project: str, zone: str, *, source_image: str,
                 token_provider: Callable[[], str] | None = None,
                 transport=_default_transport,
                 gcs_address: str = "",
                 network: str = "global/networks/default",
                 preemptible: bool = False,
                 max_retries: int = 4, timeout_s: float = 30.0,
                 backoff_s: float = 0.5, op_polls: int = 3,
                 op_poll_s: float = 2.0,
                 rng: Optional[random.Random] = None):
        self.project = project
        self.zone = zone
        self.token_provider = token_provider
        self.transport = transport
        self.gcs_address = gcs_address
        self.source_image = source_image
        self.network = network
        self.preemptible = preemptible
        self.max_retries = max_retries
        self.timeout_s = timeout_s
        self.backoff_s = backoff_s
        self.op_polls = op_polls
        self.op_poll_s = op_poll_s
        # injectable for deterministic jitter tests
        self._rng = rng if rng is not None else random.Random()
        self._token: Optional[str] = None

    # -- plumbing ----------------------------------------------------------

    def validate(self) -> None:
        """Startup credential probe: obtain one access token NOW so a
        misconfigured deployment fails at monitor launch with an actionable
        error, not at the first scale-up (reference: providers validate
        credentials at autoscaler boot)."""
        try:
            self._headers()
        except Exception as e:
            raise RuntimeError(
                f"gce_gpu provider cannot obtain an access token for "
                f"project={self.project!r} zone={self.zone!r}: {e}. On GCE "
                "the metadata server supplies it; elsewhere pass a "
                "token_provider (e.g. from service-account credentials)."
            ) from e

    @property
    def _zone_path(self) -> str:
        return f"projects/{self.project}/zones/{self.zone}"

    def _headers(self) -> Dict[str, str]:
        if self._token is None:
            # late-bound default: resolving the module attribute at CALL
            # time keeps the metadata fallback monkeypatchable/testable
            provider = self.token_provider or metadata_token_provider
            self._token = provider()
        return {"Authorization": f"Bearer {self._token}",
                "Content-Type": "application/json"}

    def _call(self, method: str, path: str, *, query: str = "",
              body: Optional[dict] = None) -> dict:
        url = f"{_BASE}/{path}" + (f"?{query}" if query else "")
        payload = json.dumps(body).encode() if body is not None else None
        delay = self.backoff_s
        last: tuple[int, bytes] = (0, b"")
        refreshed = False
        for attempt in range(self.max_retries + 1):
            try:
                status, data = self.transport(
                    method, url, self._headers(), payload, self.timeout_s)
            except Exception:
                # transport-level failure (DNS, reset): retryable
                status, data = (0, b"")
            if 200 <= status < 300:
                return json.loads(data or b"{}")
            last = (status, data)
            if status == 401 and not refreshed:
                # expired token: refresh once per call and retry immediately
                self._token = None
                refreshed = True
                continue
            if status in self.RETRYABLE or status == 0:
                err = classify_error(status, data)
                if isinstance(err, (QuotaExceededError, StockoutError)):
                    # a hard no — retrying (and sleeping) cannot help; the
                    # reconciler's type cooldown takes it from here
                    raise err
                if attempt < self.max_retries:
                    # full jitter over the exponential window: many
                    # reconcilers retrying the same 5xx must not hammer the
                    # API in lockstep at deterministic delays
                    time.sleep(self._rng.uniform(0.0, delay))
                    delay = min(delay * 2, 30.0)
                    continue
            break
        raise classify_error(*last)

    def startup_script(self, name: str) -> str:
        """The VM's boot script: the port's node agent joins the cluster as
        host ``<name>-w0``, the id node_joined's prefix match keys on."""
        if not self.gcs_address:
            return ""
        return ("#! /bin/bash\n"
                f"python -m {AGENT_MODULE} "
                f"--address {shlex.quote(self.gcs_address)} "
                f"--host-id {shlex.quote(name + '-w0')}\n")

    # -- GceGpuApi surface -------------------------------------------------

    def create_node(self, name: str, machine_type: str,
                    labels: Dict[str, str]) -> None:
        # GCE label keys/values: lowercase alnum + dash/underscore only
        clean = {str(k).lower().replace("/", "-").replace(".", "-"):
                 str(v).lower().replace("/", "-").replace(".", "-")
                 for k, v in labels.items()}
        body = {
            "name": name,
            "machineType": f"zones/{self.zone}/machineTypes/{machine_type}",
            "labels": clean,
            # a GPU VM cannot live-migrate: host maintenance stops it, and a
            # stopped VM is gone to the reconciler (relaunched on demand)
            "scheduling": {"preemptible": self.preemptible,
                           "onHostMaintenance": "TERMINATE",
                           "automaticRestart": False},
            "disks": [{"boot": True, "autoDelete": True,
                       "initializeParams": {
                           "sourceImage": self.source_image}}],
            "metadata": {"items": [{"key": "startup-script",
                                    "value": self.startup_script(name)}]},
        }
        if self.network:
            body["networkInterfaces"] = [{"network": self.network}]
        op = self._call("POST", f"{self._zone_path}/instances", body=body)
        self._check_operation(op)

    def _check_operation(self, op: dict) -> None:
        """instances.insert returns a zonal Operation; async failures (the
        common stockout mode: HTTP 200, then the operation ends with
        ZONE_RESOURCE_POOL_EXHAUSTED) must surface through the same
        quota/stockout classification as synchronous errors, or the
        reconciler relaunches every pass with no cooldown. Polls briefly;
        an operation still running after the budget is treated as success
        — the VM shows up as CREATING and state polling takes over."""
        name = op.get("name")
        for i in range(self.op_polls + 1):
            if op.get("status") == "DONE":
                if op.get("error"):
                    raise classify_operation_error(op)
                return
            if not name or i == self.op_polls:
                return  # budget spent while still running: let state polling decide
            time.sleep(self.op_poll_s)
            op = self._call("GET", f"{self._zone_path}/operations/{name}")

    def delete_node(self, name: str) -> None:
        try:
            self._call("DELETE", f"{self._zone_path}/instances/{name}")
        except ComputeApiError as e:
            if e.status == 404:
                return  # already gone — deletion is idempotent
            raise

    def list_nodes(self) -> List[str]:
        names: List[str] = []
        page = ""
        while True:
            q = "maxResults=500" + (f"&pageToken={page}" if page else "")
            resp = self._call("GET", f"{self._zone_path}/instances", query=q)
            for inst in resp.get("items") or ():
                if inst.get("status") in _TERMINAL_STATUSES:
                    continue  # preempted/stopped: reconciler must relaunch
                names.append(str(inst.get("name", "")).rsplit("/", 1)[-1])
            page = resp.get("nextPageToken") or ""
            if not page:
                return names

    def node_state(self, name: str) -> str:
        try:
            resp = self._call("GET", f"{self._zone_path}/instances/{name}")
        except ComputeApiError as e:
            if e.status == 404:
                return "ABSENT"
            raise
        status = str(resp.get("status") or "")
        if status == "RUNNING":
            return "READY"
        if status in _TERMINAL_STATUSES:
            return "ABSENT"
        if status in _CREATING_STATUSES:
            return "CREATING"
        return "CREATING" if status else "ABSENT"
