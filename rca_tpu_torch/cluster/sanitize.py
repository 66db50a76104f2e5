"""Defensive normalization of raw Kubernetes objects at the snapshot boundary
(the port's copy of ``rca_tpu.cluster.sanitize``: the Python walk, which is
the specification, and its C twin ``rca_tpu_torch/native/sanitizec.c``).

Live clusters produce objects this codebase's consumers must not have to
defend against one key at a time: a `metadata: null` from a partial
serialization, containers without a `name`, a `status` stripped by RBAC
field selectors.  The reference crashed on exactly this class of input —
its archived evidence files record AttributeErrors from malformed objects
(reference: logs/archive/20250419_190111_* per SURVEY.md §2.6) and every
agent re-implemented (or forgot) its own guards.

One pass here means every consumer downstream — feature extractor, graph
builder, all six agents, log prioritization — can rely on the invariants:

- keys that hold OBJECTS are dicts (never None): metadata, spec, status, …
- keys that hold COLLECTIONS are lists (never None): containers,
  containerStatuses, conditions, env, subsets, …
- metadata.name exists (possibly ""), metadata.labels is a dict
- containers/containerStatuses entries have a "name"

Unknown keys pass through untouched; nothing is dropped.
"""

from __future__ import annotations

from typing import Any, List

# keys whose value must be a dict when present
_DICT_KEYS = frozenset({
    "metadata", "spec", "status", "labels", "annotations", "selector",
    "matchLabels", "template", "involvedObject", "source", "resources",
    "requests", "limits", "state", "lastState", "waiting", "running",
    "terminated", "securityContext", "configMapRef", "secretRef",
    "configMapKeyRef", "secretKeyRef", "valueFrom", "configMap", "secret",
    "emptyDir", "backend", "service", "http", "scaleTargetRef", "podSelector",
    "namespaceSelector", "capacity", "allocatable", "nodeInfo", "hard",
    "used",
})

# keys whose value must be a list when present
_LIST_KEYS = frozenset({
    "containers", "initContainers", "containerStatuses",
    "initContainerStatuses", "conditions", "env", "envFrom", "volumes",
    "volumeMounts", "subsets", "addresses", "notReadyAddresses", "ports",
    "rules", "paths", "ingress", "egress", "from", "to", "items",
    "ownerReferences", "accessModes",
})

# list entries under these keys must each carry a "name"
_NAMED_LIST_KEYS = frozenset({
    "containers", "initContainers", "containerStatuses",
    "initContainerStatuses", "env",
})

# label-style maps: every value must be a string (selector matching and
# text scans concatenate/startswith them)
_STR_MAP_KEYS = frozenset({
    "labels", "annotations", "matchLabels", "nodeSelector",
})

# scalar keys: a present-but-null value is coerced to the type consumers
# compare/concatenate with (None > 0 and "".join([None]) were the two
# biggest crash classes in the structure-fuzz probe)
_INT_KEYS = frozenset({
    "restartCount", "replicas", "readyReplicas", "availableReplicas",
    "updatedReplicas", "currentReplicas", "desiredReplicas", "minReplicas",
    "maxReplicas", "exitCode", "count", "observedGeneration",
    "numberReady", "desiredNumberScheduled", "currentNumberScheduled",
})
_STR_KEYS = frozenset({
    "phase", "reason", "message", "type", "kind", "namespace", "fieldPath",
    "host", "image", "apiVersion", "component", "firstTimestamp",
    "lastTimestamp", "creationTimestamp", "startedAt", "finishedAt",
})


def _empty_metadata() -> dict:
    """A fresh metadata satisfying the module invariant (name + labels) —
    the single Python-side spelling; sanitizec.c's empty_metadata() is its
    twin."""
    return {"name": "", "labels": {}}


def sanitize_object(obj: Any, parent_key: str = "") -> Any:
    """Recursively normalize one K8s object (see module docstring).

    Copy-on-write: well-formed subtrees (the overwhelmingly common case)
    are returned AS-IS with zero allocations — this runs over every object
    of every snapshot, including the 1 Hz live-streaming captures, where a
    rebuild-everything version measured ~1.6 s at 10k pods."""
    if obj is None:
        if parent_key == "metadata":
            return _empty_metadata()
        if parent_key in _DICT_KEYS:
            return {}
        if parent_key in _LIST_KEYS:
            return []
        return None
    cls = obj.__class__
    if cls is dict:
        if parent_key in _STR_MAP_KEYS:
            if all(
                type(k) is str and type(v) is str for k, v in obj.items()
            ):
                return obj
            return {
                str(k): ("" if v is None else str(v))
                for k, v in obj.items()
            }
        out = None  # allocated only when something changes
        for k, v in obj.items():
            # "status" is a DICT at object top level (pod.status) but a
            # STRING inside condition entries ({type, status: "True"});
            # strip the key context there so neither the None branch nor
            # the dict coercion below wipes a legitimate string
            child_key = (
                "" if (parent_key == "conditions" and k == "status") else k
            )
            nv = sanitize_object(v, child_key)
            if nv is None:
                if child_key in _INT_KEYS:
                    nv = 0
                elif child_key in _STR_KEYS:
                    nv = ""
            elif child_key in _DICT_KEYS and nv.__class__ is not dict:
                # same repair as the None branch: a replaced metadata must
                # still satisfy the name/labels invariant
                nv = _empty_metadata() if child_key == "metadata" else {}
            elif child_key in _LIST_KEYS and nv.__class__ is not list:
                nv = []
            if nv is not v:
                if out is None:
                    out = dict(obj)
                out[k] = nv
        result = out if out is not None else obj
        if parent_key == "metadata":
            name = result.get("name")
            labels = result.get("labels")
            # a missing name reads as None -> the same repair branch
            if type(name) is not str or type(labels) is not dict:
                if result is obj:
                    result = dict(obj)
                result["name"] = (
                    name if type(name) is str else str(name or "")
                )
                if type(labels) is not dict:
                    result["labels"] = {}
        return result
    if cls is list:
        named = parent_key in _NAMED_LIST_KEYS
        is_env = parent_key == "env"
        obj_entries = parent_key in _LIST_KEYS and parent_key != "accessModes"
        out = None
        for i, v in enumerate(obj):
            if v is None and obj_entries:
                # a null ELEMENT of an object list becomes an empty object,
                # not a nested [] (the parent_key-recursion trap) — the
                # named-list pass below then gives it a "" name
                nv = {}
            else:
                nv = sanitize_object(v, parent_key)
            if nv.__class__ is dict:
                if named and type(nv.get("name")) is not str:
                    nv = {**nv, "name": str(nv.get("name") or "")}
                if is_env and not nv.get("valueFrom") \
                        and nv.get("value") is None:
                    nv = {**nv, "value": ""}
            if nv is not v:
                if out is None:
                    out = list(obj)
                out[i] = nv
        return out if out is not None else obj
    return obj


def _native_sanitize():
    """The C extension twin (rca_tpu_torch/native/sanitizec.c), or None.
    Same walk in C; exact parity is enforced by
    tests/test_torch_native.py, and the Python implementation above is the
    spec."""
    from rca_tpu_torch.native import load_sanitize

    return load_sanitize()


def sanitize_objects(items: List[dict]) -> List[dict]:
    """Normalize a collection; drops entries that are not dicts at all."""
    native = _native_sanitize()
    san = native.sanitize_object if native is not None else sanitize_object
    out = []
    for item in items or []:
        if not isinstance(item, dict):
            continue
        clean = san(item)
        # every top-level object gets a metadata dict with a name
        md = clean.get("metadata")
        if not isinstance(md, dict):
            clean = dict(clean) if clean is item else clean
            clean["metadata"] = _empty_metadata()
        elif "name" not in md or not isinstance(md.get("labels"), dict):
            clean = dict(clean) if clean is item else clean
            md = dict(md)
            md.setdefault("name", "")
            if not isinstance(md.get("labels"), dict):
                md["labels"] = {}
            clean["metadata"] = md
        out.append(clean)
    return out
