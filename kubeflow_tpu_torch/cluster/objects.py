"""k8s-shaped object model (copy of kubeflow_tpu/cluster/objects.py).

Objects are plain dicts shaped like Kubernetes API objects (apiVersion, kind,
metadata, spec, status) so they serialize to the same YAML the reference's
CRDs use (reference CRD shapes: components/notebook-controller/api/v1beta1/
notebook_types.go:27-45, profile-controller/api/v1/profile_types.go:38-43)
and render directly to real manifests when a live cluster exists.

Status conditions follow the k8s convention the reference's tests poll
(reference: testing/katib_studyjob_test.py:128-193 wait_for_condition).
"""

from __future__ import annotations

import copy
import dataclasses
import time
import uuid
from typing import Any, Dict, List, Optional

GROUP = "kubeflow-tpu.dev"
DEFAULT_API_VERSION = f"{GROUP}/v1beta1"


def now_iso() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def new_object(
    kind: str,
    name: str,
    namespace: str = "default",
    spec: Optional[Dict[str, Any]] = None,
    labels: Optional[Dict[str, str]] = None,
    annotations: Optional[Dict[str, str]] = None,
    api_version: str = DEFAULT_API_VERSION,
) -> Dict[str, Any]:
    return {
        "apiVersion": api_version,
        "kind": kind,
        "metadata": {
            "name": name,
            "namespace": namespace,
            "labels": dict(labels or {}),
            "annotations": dict(annotations or {}),
        },
        "spec": copy.deepcopy(spec) if spec else {},
        "status": {},
    }


def meta(obj: Dict[str, Any]) -> Dict[str, Any]:
    return obj.setdefault("metadata", {})


def namespaced_name(obj: Dict[str, Any]) -> str:
    m = obj.get("metadata", {})
    return f"{m.get('namespace', 'default')}/{m.get('name', '')}"


def pod_host(pod: Dict[str, Any]) -> str:
    """The address another process reaches this pod at — ONE definition
    of the preference order shared by every pod-dialing consumer (the
    fleet collector's scrape targets, the kft-router's replica
    registry): the reported pod IP, else the pod's gang DNS name
    (hostname.subdomain.namespace), else the bare pod name."""
    m = pod.get("metadata", {})
    spec = pod.get("spec") or {}
    host = (pod.get("status") or {}).get("podIP") or ""
    if not host:
        hostname = spec.get("hostname") or m.get("name", "")
        subdomain = spec.get("subdomain", "")
        ns = m.get("namespace", "default")
        host = f"{hostname}.{subdomain}.{ns}" if subdomain else hostname
    return host


def owner_reference(owner: Dict[str, Any], controller: bool = True) -> Dict[str, Any]:
    m = owner["metadata"]
    return {
        "apiVersion": owner.get("apiVersion", DEFAULT_API_VERSION),
        "kind": owner["kind"],
        "name": m["name"],
        "uid": m.get("uid", ""),
        "controller": controller,
    }


def set_owner(obj: Dict[str, Any], owner: Dict[str, Any]) -> None:
    refs = meta(obj).setdefault("ownerReferences", [])
    ref = owner_reference(owner)
    for existing in refs:
        if existing.get("uid") == ref["uid"] and existing.get("name") == ref["name"]:
            return
    refs.append(ref)


def is_owned_by(obj: Dict[str, Any], owner: Dict[str, Any]) -> bool:
    ouid = owner.get("metadata", {}).get("uid")
    for ref in obj.get("metadata", {}).get("ownerReferences", []):
        if ref.get("uid") == ouid:
            return True
    return False


@dataclasses.dataclass
class Condition:
    type: str
    status: str  # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    last_transition_time: str = ""

    def to_dict(self) -> Dict[str, str]:
        return {
            "type": self.type,
            "status": self.status,
            "reason": self.reason,
            "message": self.message,
            "lastTransitionTime": self.last_transition_time or now_iso(),
        }


def set_condition(
    obj: Dict[str, Any],
    type: str,
    status: str,
    reason: str = "",
    message: str = "",
) -> bool:
    """Set/replace a status condition; returns True if it changed."""
    conditions: List[Dict[str, Any]] = obj.setdefault("status", {}).setdefault(
        "conditions", []
    )
    for c in conditions:
        if c.get("type") == type:
            if c.get("status") == status and c.get("reason") == reason:
                return False
            c.update(
                status=status,
                reason=reason,
                message=message,
                lastTransitionTime=now_iso(),
            )
            return True
    conditions.append(Condition(type, status, reason, message).to_dict())
    return True


def get_condition(obj: Dict[str, Any], type: str) -> Optional[Dict[str, Any]]:
    for c in obj.get("status", {}).get("conditions", []):
        if c.get("type") == type:
            return c
    return None


def condition_is_true(obj: Dict[str, Any], type: str) -> bool:
    c = get_condition(obj, type)
    return c is not None and c.get("status") == "True"


def fresh_uid() -> str:
    return str(uuid.uuid4())


def matches_selector(obj: Dict[str, Any], selector: Dict[str, str]) -> bool:
    labels = obj.get("metadata", {}).get("labels", {}) or {}
    return all(labels.get(k) == v for k, v in selector.items())
