/* Native K8s-object sanitizer: CPython extension twin of
 * rca_tpu_torch/cluster/sanitize.py.
 *
 * The Python sanitizer walks ~1.2M nodes per 10k-pod snapshot — pure
 * CPython call overhead (~0.6 s); this extension does the same walk with
 * identical copy-on-write semantics in ~tens of ms.  Exact behavioral
 * parity with the Python implementation is enforced by
 * tests/test_torch_native.py (fuzzed objects through both, deep equality) —
 * any divergence is a bug HERE, the Python version is the spec.
 *
 * Built lazily by rca_tpu_torch.native.load_sanitize() with g++ against the
 * interpreter's own headers; the Python path is the always-available
 * fallback (RCA_NATIVE_SANITIZE=0 disables).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>

/* ---- key sets (mirror sanitize.py; keep sorted groups in sync) ------- */

static const char *DICT_KEYS[] = {
    "metadata", "spec", "status", "labels", "annotations", "selector",
    "matchLabels", "template", "involvedObject", "source", "resources",
    "requests", "limits", "state", "lastState", "waiting", "running",
    "terminated", "securityContext", "configMapRef", "secretRef",
    "configMapKeyRef", "secretKeyRef", "valueFrom", "configMap", "secret",
    "emptyDir", "backend", "service", "http", "scaleTargetRef",
    "podSelector", "namespaceSelector", "capacity", "allocatable",
    "nodeInfo", "hard", "used", NULL,
};

static const char *LIST_KEYS[] = {
    "containers", "initContainers", "containerStatuses",
    "initContainerStatuses", "conditions", "env", "envFrom", "volumes",
    "volumeMounts", "subsets", "addresses", "notReadyAddresses", "ports",
    "rules", "paths", "ingress", "egress", "from", "to", "items",
    "ownerReferences", "accessModes", NULL,
};

static const char *NAMED_LIST_KEYS[] = {
    "containers", "initContainers", "containerStatuses",
    "initContainerStatuses", "env", NULL,
};

static const char *STR_MAP_KEYS[] = {
    "labels", "annotations", "matchLabels", "nodeSelector", NULL,
};

static const char *INT_KEYS[] = {
    "restartCount", "replicas", "readyReplicas", "availableReplicas",
    "updatedReplicas", "currentReplicas", "desiredReplicas", "minReplicas",
    "maxReplicas", "exitCode", "count", "observedGeneration",
    "numberReady", "desiredNumberScheduled", "currentNumberScheduled", NULL,
};

static const char *STR_KEYS[] = {
    "phase", "reason", "message", "type", "kind", "namespace", "fieldPath",
    "host", "image", "apiVersion", "component", "firstTimestamp",
    "lastTimestamp", "creationTimestamp", "startedAt", "finishedAt", NULL,
};

static int in_set(const char *key, const char **set) {
    if (key == NULL) return 0;
    const char k0 = key[0];
    for (const char **p = set; *p; ++p) {
        /* first-char pre-filter: most probes fail here without a strcmp */
        if ((*p)[0] == k0 && strcmp(key, *p) == 0) return 1;
    }
    return 0;
}

/* utf8 of an exact-str key, or NULL for non-string / non-encodable keys
 * (a lone-surrogate key sets a UnicodeEncodeError that MUST be cleared,
 * or the extension returns a value with an exception pending) */
static const char *key_utf8(PyObject *k) {
    /* subclass-of-str keys must classify like the spec (frozenset
     * membership is hash/eq based), so Check, not CheckExact */
    if (!PyUnicode_Check(k)) return NULL;
    const char *s = PyUnicode_AsUTF8(k);
    if (s == NULL) PyErr_Clear();
    return s;
}

/* str(x or "") — falsy -> "", else str(x).  New reference. */
static PyObject *str_or_empty(PyObject *x) {
    int truthy = x == NULL ? 0 : PyObject_IsTrue(x);
    if (truthy < 0) return NULL;
    if (!truthy) return PyUnicode_FromString("");
    return PyObject_Str(x);
}

static PyObject *empty_metadata(void) {
    PyObject *md = PyDict_New();
    if (!md) return NULL;
    PyObject *name = PyUnicode_FromString("");
    PyObject *labels = PyDict_New();
    if (!name || !labels ||
        PyDict_SetItemString(md, "name", name) < 0 ||
        PyDict_SetItemString(md, "labels", labels) < 0) {
        Py_XDECREF(name); Py_XDECREF(labels); Py_DECREF(md);
        return NULL;
    }
    Py_DECREF(name); Py_DECREF(labels);
    return md;
}

/* forward */
static PyObject *sanitize(PyObject *obj, const char *parent_key);

/* metadata name/labels repair on a dict; returns new ref (may be obj). */
static PyObject *fix_metadata(PyObject *md, PyObject *orig) {
    PyObject *name = PyDict_GetItemString(md, "name");      /* borrowed */
    PyObject *labels = PyDict_GetItemString(md, "labels");  /* borrowed */
    int name_ok = name != NULL && PyUnicode_CheckExact(name);
    int labels_ok = labels != NULL && PyDict_CheckExact(labels);
    if (name_ok && labels_ok) { Py_INCREF(md); return md; }
    PyObject *out = md == orig ? PyDict_Copy(md) : (Py_INCREF(md), md);
    if (!out) return NULL;
    PyObject *fixed_name = name_ok ? NULL : str_or_empty(name);
    if (!name_ok) {
        if (!fixed_name || PyDict_SetItemString(out, "name", fixed_name) < 0) {
            Py_XDECREF(fixed_name); Py_DECREF(out); return NULL;
        }
        Py_DECREF(fixed_name);
    }
    if (!labels_ok) {
        PyObject *fresh = PyDict_New();
        if (!fresh || PyDict_SetItemString(out, "labels", fresh) < 0) {
            Py_XDECREF(fresh); Py_DECREF(out); return NULL;
        }
        Py_DECREF(fresh);
    }
    return out;
}

static PyObject *sanitize_dict(PyObject *obj, const char *parent_key) {
    if (in_set(parent_key, STR_MAP_KEYS)) {
        /* all-string fast path */
        PyObject *k, *v; Py_ssize_t pos = 0; int clean = 1;
        while (PyDict_Next(obj, &pos, &k, &v)) {
            if (!PyUnicode_CheckExact(k) || !PyUnicode_CheckExact(v)) {
                clean = 0; break;
            }
        }
        if (clean) { Py_INCREF(obj); return obj; }
        PyObject *out = PyDict_New();
        if (!out) return NULL;
        pos = 0;
        while (PyDict_Next(obj, &pos, &k, &v)) {
            PyObject *ks = PyObject_Str(k);
            PyObject *vs = v == Py_None ? PyUnicode_FromString("")
                                        : PyObject_Str(v);
            if (!ks || !vs || PyDict_SetItem(out, ks, vs) < 0) {
                Py_XDECREF(ks); Py_XDECREF(vs); Py_DECREF(out); return NULL;
            }
            Py_DECREF(ks); Py_DECREF(vs);
        }
        return out;
    }

    int in_conditions = parent_key && strcmp(parent_key, "conditions") == 0;
    PyObject *out = NULL;  /* allocated only when something changes */
    PyObject *k, *v; Py_ssize_t pos = 0;
    while (PyDict_Next(obj, &pos, &k, &v)) {
        const char *ku = key_utf8(k);
        /* "status" is a dict at object top level but a STRING inside
         * condition entries — strip the key context there (spec:
         * sanitize.py child_key) */
        if (in_conditions && ku && strcmp(ku, "status") == 0) ku = "";
        PyObject *nv = sanitize(v, ku);  /* new ref */
        if (!nv) { Py_XDECREF(out); return NULL; }
        if (nv == Py_None) {
            if (in_set(ku, INT_KEYS)) {
                Py_DECREF(nv); nv = PyLong_FromLong(0);
            } else if (in_set(ku, STR_KEYS)) {
                Py_DECREF(nv); nv = PyUnicode_FromString("");
            }
        } else if (in_set(ku, DICT_KEYS) && !PyDict_CheckExact(nv)) {
            /* a replaced metadata must still satisfy the name/labels
             * invariant — same repair as the None branch (spec:
             * sanitize.py metadata coercion) */
            Py_DECREF(nv);
            nv = (ku && strcmp(ku, "metadata") == 0) ? empty_metadata()
                                                     : PyDict_New();
        } else if (in_set(ku, LIST_KEYS) && !PyList_CheckExact(nv)) {
            Py_DECREF(nv); nv = PyList_New(0);
        }
        if (!nv) { Py_XDECREF(out); return NULL; }
        if (nv != v) {
            if (out == NULL) {
                out = PyDict_Copy(obj);
                if (!out) { Py_DECREF(nv); return NULL; }
            }
            if (PyDict_SetItem(out, k, nv) < 0) {
                Py_DECREF(nv); Py_DECREF(out); return NULL;
            }
        }
        Py_DECREF(nv);
    }
    PyObject *result = out ? out : (Py_INCREF(obj), obj);
    if (parent_key && strcmp(parent_key, "metadata") == 0) {
        PyObject *fixed = fix_metadata(result, obj);
        Py_DECREF(result);
        return fixed;
    }
    return result;
}

static PyObject *sanitize_list(PyObject *obj, const char *parent_key) {
    int named = in_set(parent_key, NAMED_LIST_KEYS);
    int is_env = parent_key && strcmp(parent_key, "env") == 0;
    int obj_entries = in_set(parent_key, LIST_KEYS) &&
        !(parent_key && strcmp(parent_key, "accessModes") == 0);
    PyObject *out = NULL;
    Py_ssize_t n = PyList_GET_SIZE(obj);
    for (Py_ssize_t i = 0; i < n; ++i) {
        PyObject *v = PyList_GET_ITEM(obj, i);  /* borrowed */
        PyObject *nv;
        if (v == Py_None && obj_entries) {
            nv = PyDict_New();
        } else {
            nv = sanitize(v, parent_key);
        }
        if (!nv) { Py_XDECREF(out); return NULL; }
        if (PyDict_CheckExact(nv)) {
            if (named) {
                PyObject *name = PyDict_GetItemString(nv, "name");
                if (name == NULL || !PyUnicode_CheckExact(name)) {
                    PyObject *copy = nv == v ? PyDict_Copy(nv)
                                             : (Py_INCREF(nv), nv);
                    Py_DECREF(nv);
                    if (!copy) { Py_XDECREF(out); return NULL; }
                    nv = copy;
                    PyObject *fixed = str_or_empty(name);
                    if (!fixed ||
                        PyDict_SetItemString(nv, "name", fixed) < 0) {
                        Py_XDECREF(fixed); Py_DECREF(nv);
                        Py_XDECREF(out); return NULL;
                    }
                    Py_DECREF(fixed);
                }
            }
            if (is_env) {
                PyObject *vf = PyDict_GetItemString(nv, "valueFrom");
                int has_vf = vf == NULL ? 0 : PyObject_IsTrue(vf);
                if (has_vf < 0) { Py_DECREF(nv); Py_XDECREF(out); return NULL; }
                /* spec uses nv.get("value") is None: a MISSING value key
                 * is normalized to "" too */
                PyObject *val = PyDict_GetItemString(nv, "value");
                int val_is_null = (val == NULL || val == Py_None);
                if (!has_vf && val_is_null) {
                    PyObject *copy = nv == v ? PyDict_Copy(nv)
                                             : (Py_INCREF(nv), nv);
                    Py_DECREF(nv);
                    if (!copy) { Py_XDECREF(out); return NULL; }
                    nv = copy;
                    PyObject *empty = PyUnicode_FromString("");
                    if (!empty ||
                        PyDict_SetItemString(nv, "value", empty) < 0) {
                        Py_XDECREF(empty); Py_DECREF(nv);
                        Py_XDECREF(out); return NULL;
                    }
                    Py_DECREF(empty);
                }
            }
        }
        if (nv != v) {
            if (out == NULL) {
                out = PyList_GetSlice(obj, 0, n);
                if (!out) { Py_DECREF(nv); return NULL; }
            }
            /* PyList_SetItem steals nv */
            if (PyList_SetItem(out, i, nv) < 0) {
                Py_DECREF(out); return NULL;
            }
        } else {
            Py_DECREF(nv);
        }
    }
    return out ? out : (Py_INCREF(obj), obj);
}

static PyObject *sanitize(PyObject *obj, const char *parent_key) {
    if (obj == Py_None) {
        if (parent_key && strcmp(parent_key, "metadata") == 0)
            return empty_metadata();
        if (in_set(parent_key, DICT_KEYS)) return PyDict_New();
        if (in_set(parent_key, LIST_KEYS)) return PyList_New(0);
        Py_RETURN_NONE;
    }
    if (PyDict_CheckExact(obj) || PyList_CheckExact(obj)) {
        /* convert hostile nesting depth into RecursionError like the
         * Python spec, instead of overflowing the C stack */
        if (Py_EnterRecursiveCall(" in rca_tpu_torch native sanitize"))
            return NULL;
        PyObject *out = PyDict_CheckExact(obj)
            ? sanitize_dict(obj, parent_key)
            : sanitize_list(obj, parent_key);
        Py_LeaveRecursiveCall();
        return out;
    }
    Py_INCREF(obj);
    return obj;
}

/* ---- module ---------------------------------------------------------- */

static PyObject *py_sanitize_object(PyObject *self, PyObject *args) {
    PyObject *obj;
    const char *parent_key = "";
    if (!PyArg_ParseTuple(args, "O|s", &obj, &parent_key)) return NULL;
    return sanitize(obj, parent_key);
}

static PyMethodDef Methods[] = {
    {"sanitize_object", py_sanitize_object, METH_VARARGS,
     "Recursively normalize one K8s object (native twin of "
     "rca_tpu_torch.cluster.sanitize.sanitize_object)."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "sanitizec", NULL, -1, Methods,
};

PyMODINIT_FUNC PyInit_sanitizec(void) {
    return PyModule_Create(&moduledef);
}
