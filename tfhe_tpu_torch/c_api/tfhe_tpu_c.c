/* tfhe_tpu_torch C API implementation: embeds CPython and dispatches into
 * the port (tfhe_tpu_torch.high_level_api.api, tfhe_tpu_torch.utils.
 * serialization, tfhe_tpu_torch.utils.params.PARAMS_BY_NAME), as
 * c_api/tfhe_tpu_c.c does into tfhe_tpu (the analog of the reference's Rust
 * c_api layer, tfhe/src/c_api/: opaque boxes + catch_panic -> error codes
 * here become PyErr -> error codes).
 *
 * Keys and deserialized ciphertexts go to the device of the init: the GPU
 * for tfhe_tpu_init(), any torch device for tfhe_tpu_init_on().
 *
 * Build: tfhe_tpu_torch/_build.py (c_api_build), with cc. The library does
 * not link libpython: a program that embeds it links the interpreter
 * itself, and loaded into a running interpreter (ctypes.PyDLL) its symbols
 * resolve against that interpreter. The interpreter is initialized lazily
 * when none runs.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdio.h>
#include <string.h>

#include "tfhe_tpu.h"

static char g_last_error[4096] = "";
static PyObject *g_api = NULL; /* tfhe_tpu_torch.high_level_api.api */
static PyObject *g_ser = NULL; /* tfhe_tpu_torch.utils.serialization */
static PyObject *g_device = NULL; /* str: the torch device of the init */

struct TfheClientKey { PyObject *obj; };
struct TfheServerKey { PyObject *obj; };
struct TfheFheUint   { PyObject *obj; uint32_t bits; };

/* ---------------------------------------------------------------------- */

static void set_error_from_python(void) {
    PyObject *type, *value, *tb;
    PyErr_Fetch(&type, &value, &tb);
    if (value) {
        PyObject *s = PyObject_Str(value);
        if (s) {
            const char *msg = PyUnicode_AsUTF8(s);
            snprintf(g_last_error, sizeof(g_last_error), "%s",
                     msg ? msg : "<unprintable python error>");
            Py_DECREF(s);
        }
    } else {
        snprintf(g_last_error, sizeof(g_last_error), "unknown python error");
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
}

const char *tfhe_tpu_last_error(void) { return g_last_error; }

/* str(tfhe_tpu_torch._device.resolve_device(device)): NULL means the GPU,
 * and raises without one. New reference, NULL on error. */
static PyObject *resolve_device(const char *device) {
    PyObject *mod = PyImport_ImportModule("tfhe_tpu_torch._device");
    if (!mod) return NULL;
    PyObject *arg = device ? PyUnicode_FromString(device)
                           : Py_NewRef(Py_None);
    PyObject *dev = arg ? PyObject_CallMethod(mod, "resolve_device", "O", arg)
                        : NULL;
    Py_XDECREF(arg);
    Py_DECREF(mod);
    if (!dev) return NULL;
    PyObject *name = PyObject_Str(dev);
    Py_DECREF(dev);
    return name;
}

int tfhe_tpu_init_on(const char *device) {
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
    }
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = 1;
    PyObject *dev = resolve_device(device);
    if (!dev) goto done;
    if (!g_api) g_api = PyImport_ImportModule(
        "tfhe_tpu_torch.high_level_api.api");
    if (!g_api) goto done;
    if (!g_ser) g_ser = PyImport_ImportModule(
        "tfhe_tpu_torch.utils.serialization");
    if (!g_ser) goto done;
    Py_XSETREF(g_device, dev);
    dev = NULL;
    rc = 0;
done:
    if (rc) {
        set_error_from_python();
        Py_CLEAR(g_api);
        Py_CLEAR(g_ser);
        Py_CLEAR(g_device);
    }
    Py_XDECREF(dev);
    PyGILState_Release(st);
    return rc;
}

int tfhe_tpu_init(void) {
    if (g_api) return 0;
    return tfhe_tpu_init_on(NULL);
}

int tfhe_tpu_shutdown(void) {
    if (!Py_IsInitialized()) return 0;
    PyGILState_STATE st = PyGILState_Ensure();
    Py_CLEAR(g_api);
    Py_CLEAR(g_ser);
    Py_CLEAR(g_device);
    PyGILState_Release(st);
    return 0;
}

#define REQUIRE_INIT() \
    do { if (!g_api && tfhe_tpu_init() != 0) return 1; } while (0)

/* call <module>.<name>(*args, device=<the init's device> when on_device)
 * with a new reference result, NULL on error */
static PyObject *module_call(PyObject *module, const char *name,
                             PyObject *args, int on_device) {
    PyObject *fn = PyObject_GetAttrString(module, name);
    if (!fn) return NULL;
    PyObject *kwargs = on_device ? Py_BuildValue("{s:O}", "device", g_device)
                                 : NULL;
    PyObject *res = (!on_device || kwargs)
        ? PyObject_Call(fn, args, kwargs) : NULL;
    Py_XDECREF(kwargs);
    Py_DECREF(fn);
    return res;
}

static PyObject *api_call(const char *name, PyObject *args) {
    return module_call(g_api, name, args, 0);
}

/* ---------------------------------------------------------------------- */

int tfhe_tpu_generate_keys(const char *param_set_name, uint64_t seed,
                           TfheClientKey **client_key,
                           TfheServerKey **server_key) {
    REQUIRE_INIT();
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = 1;
    PyObject *params = NULL, *cfg = NULL, *pair = NULL, *args = NULL;
    PyObject *mod_params = PyImport_ImportModule(
        "tfhe_tpu_torch.utils.params");
    if (!mod_params) goto fail;
    {
        PyObject *by_name = PyObject_GetAttrString(mod_params, "PARAMS_BY_NAME");
        if (!by_name) goto fail;
        params = PyMapping_GetItemString(by_name, param_set_name);
        Py_DECREF(by_name);
        if (!params) goto fail;
    }
    {
        PyObject *cfg_cls = PyObject_GetAttrString(g_api, "Config");
        PyObject *seed_obj = PyLong_FromUnsignedLongLong(
            (unsigned long long)seed);
        if (!cfg_cls || !seed_obj) {
            Py_XDECREF(cfg_cls);
            Py_XDECREF(seed_obj);
            goto fail;
        }
        cfg = PyObject_CallFunctionObjArgs(cfg_cls, params, seed_obj, NULL);
        Py_DECREF(cfg_cls);
        Py_DECREF(seed_obj);
        if (!cfg) goto fail;
    }
    args = Py_BuildValue("(O)", cfg);
    if (!args) goto fail;
    pair = module_call(g_api, "generate_keys", args, 1);
    if (!pair) goto fail;
    {
        PyObject *ck = PySequence_GetItem(pair, 0);
        PyObject *sk = PySequence_GetItem(pair, 1);
        if (!ck || !sk) { Py_XDECREF(ck); Py_XDECREF(sk); goto fail; }
        *client_key = (TfheClientKey *)malloc(sizeof(TfheClientKey));
        *server_key = (TfheServerKey *)malloc(sizeof(TfheServerKey));
        (*client_key)->obj = ck;
        (*server_key)->obj = sk;
    }
    rc = 0;
fail:
    if (rc) set_error_from_python();
    Py_XDECREF(args);
    Py_XDECREF(pair);
    Py_XDECREF(cfg);
    Py_XDECREF(params);
    Py_XDECREF(mod_params);
    PyGILState_Release(st);
    return rc;
}

int tfhe_tpu_set_server_key(TfheServerKey *server_key) {
    REQUIRE_INIT();
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *args = Py_BuildValue("(O)", server_key->obj);
    PyObject *res = args ? api_call("set_server_key", args) : NULL;
    int rc = res ? 0 : 1;
    if (rc) set_error_from_python();
    Py_XDECREF(args);
    Py_XDECREF(res);
    PyGILState_Release(st);
    return rc;
}

void tfhe_tpu_client_key_destroy(TfheClientKey *key) {
    if (!key) return;
    PyGILState_STATE st = PyGILState_Ensure();
    Py_XDECREF(key->obj);
    PyGILState_Release(st);
    free(key);
}

void tfhe_tpu_server_key_destroy(TfheServerKey *key) {
    if (!key) return;
    PyGILState_STATE st = PyGILState_Ensure();
    Py_XDECREF(key->obj);
    PyGILState_Release(st);
    free(key);
}

/* ---------------------------------------------------------------------- */

static PyObject *fheuint_type(uint32_t bits) {
    char name[32];
    snprintf(name, sizeof(name), "FheUint%u", bits);
    return PyObject_GetAttrString(g_api, name);
}

int tfhe_tpu_fheuint_encrypt(uint32_t bit_width, uint64_t clear,
                             TfheClientKey *key, TfheFheUint **out) {
    REQUIRE_INIT();
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = 1;
    PyObject *ty = fheuint_type(bit_width);
    PyObject *res = NULL;
    if (ty) {
        res = PyObject_CallMethod(ty, "encrypt", "KO",
                                  (unsigned long long)clear, key->obj);
    }
    if (res) {
        *out = (TfheFheUint *)malloc(sizeof(TfheFheUint));
        (*out)->obj = res;
        (*out)->bits = bit_width;
        rc = 0;
    } else {
        set_error_from_python();
    }
    Py_XDECREF(ty);
    PyGILState_Release(st);
    return rc;
}

int tfhe_tpu_fheuint_try_encrypt_trivial(uint32_t bit_width, uint64_t clear,
                                         TfheFheUint **out) {
    REQUIRE_INIT();
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = 1;
    PyObject *ty = fheuint_type(bit_width);
    PyObject *res = NULL;
    if (ty) {
        res = PyObject_CallMethod(ty, "encrypt_trivial", "K",
                                  (unsigned long long)clear);
    }
    if (res) {
        *out = (TfheFheUint *)malloc(sizeof(TfheFheUint));
        (*out)->obj = res;
        (*out)->bits = bit_width;
        rc = 0;
    } else {
        set_error_from_python();
    }
    Py_XDECREF(ty);
    PyGILState_Release(st);
    return rc;
}

int tfhe_tpu_fheuint_decrypt(TfheFheUint *ct, TfheClientKey *key,
                             uint64_t *clear_out) {
    REQUIRE_INIT();
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = 1;
    PyObject *res = PyObject_CallMethod(ct->obj, "decrypt", "O", key->obj);
    if (res) {
        PyObject *as_int = PyNumber_Long(res);
        if (as_int) {
            *clear_out = PyLong_AsUnsignedLongLongMask(as_int);
            Py_DECREF(as_int);
            rc = 0;
        }
        Py_DECREF(res);
    }
    if (rc) set_error_from_python();
    PyGILState_Release(st);
    return rc;
}

void tfhe_tpu_fheuint_destroy(TfheFheUint *ct) {
    if (!ct) return;
    PyGILState_STATE st = PyGILState_Ensure();
    Py_XDECREF(ct->obj);
    PyGILState_Release(st);
    free(ct);
}

static int binop(TfheFheUint *lhs, TfheFheUint *rhs, TfheFheUint **out,
                 const char *dunder) {
    REQUIRE_INIT();
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = 1;
    PyObject *res = PyObject_CallMethod(lhs->obj, dunder, "O", rhs->obj);
    if (res && res != Py_NotImplemented) {
        *out = (TfheFheUint *)malloc(sizeof(TfheFheUint));
        (*out)->obj = res;
        (*out)->bits = lhs->bits;
        rc = 0;
    } else {
        Py_XDECREF(res);
        set_error_from_python();
    }
    PyGILState_Release(st);
    return rc;
}

int tfhe_tpu_fheuint_add(TfheFheUint *l, TfheFheUint *r, TfheFheUint **o)
{ return binop(l, r, o, "__add__"); }
int tfhe_tpu_fheuint_sub(TfheFheUint *l, TfheFheUint *r, TfheFheUint **o)
{ return binop(l, r, o, "__sub__"); }
int tfhe_tpu_fheuint_mul(TfheFheUint *l, TfheFheUint *r, TfheFheUint **o)
{ return binop(l, r, o, "__mul__"); }
int tfhe_tpu_fheuint_bitand(TfheFheUint *l, TfheFheUint *r, TfheFheUint **o)
{ return binop(l, r, o, "__and__"); }
int tfhe_tpu_fheuint_bitor(TfheFheUint *l, TfheFheUint *r, TfheFheUint **o)
{ return binop(l, r, o, "__or__"); }
int tfhe_tpu_fheuint_bitxor(TfheFheUint *l, TfheFheUint *r, TfheFheUint **o)
{ return binop(l, r, o, "__xor__"); }
int tfhe_tpu_fheuint_eq(TfheFheUint *l, TfheFheUint *r, TfheFheUint **o)
{ return binop(l, r, o, "eq"); }
int tfhe_tpu_fheuint_lt(TfheFheUint *l, TfheFheUint *r, TfheFheUint **o)
{ return binop(l, r, o, "lt"); }
int tfhe_tpu_fheuint_ne(TfheFheUint *l, TfheFheUint *r, TfheFheUint **o)
{ return binop(l, r, o, "ne"); }
int tfhe_tpu_fheuint_le(TfheFheUint *l, TfheFheUint *r, TfheFheUint **o)
{ return binop(l, r, o, "le"); }
int tfhe_tpu_fheuint_gt(TfheFheUint *l, TfheFheUint *r, TfheFheUint **o)
{ return binop(l, r, o, "gt"); }
int tfhe_tpu_fheuint_ge(TfheFheUint *l, TfheFheUint *r, TfheFheUint **o)
{ return binop(l, r, o, "ge"); }
int tfhe_tpu_fheuint_min(TfheFheUint *l, TfheFheUint *r, TfheFheUint **o)
{ return binop(l, r, o, "min"); }
int tfhe_tpu_fheuint_max(TfheFheUint *l, TfheFheUint *r, TfheFheUint **o)
{ return binop(l, r, o, "max"); }
int tfhe_tpu_fheuint_div(TfheFheUint *l, TfheFheUint *r, TfheFheUint **o)
{ return binop(l, r, o, "__floordiv__"); }
int tfhe_tpu_fheuint_rem(TfheFheUint *l, TfheFheUint *r, TfheFheUint **o)
{ return binop(l, r, o, "__mod__"); }

static int unop(TfheFheUint *ct, TfheFheUint **out, const char *meth) {
    REQUIRE_INIT();
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = 1;
    PyObject *res = PyObject_CallMethod(ct->obj, meth, NULL);
    if (res && res != Py_NotImplemented) {
        *out = (TfheFheUint *)malloc(sizeof(TfheFheUint));
        (*out)->obj = res;
        (*out)->bits = ct->bits;
        rc = 0;
    } else {
        Py_XDECREF(res);
        set_error_from_python();
    }
    PyGILState_Release(st);
    return rc;
}

int tfhe_tpu_fheuint_neg(TfheFheUint *ct, TfheFheUint **o)
{ return unop(ct, o, "__neg__"); }
int tfhe_tpu_fheuint_not(TfheFheUint *ct, TfheFheUint **o)
{ return unop(ct, o, "__invert__"); }

static int scalar_op(TfheFheUint *lhs, uint64_t rhs, TfheFheUint **out,
                     const char *dunder) {
    REQUIRE_INIT();
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = 1;
    PyObject *res = PyObject_CallMethod(lhs->obj, dunder, "K",
                                        (unsigned long long)rhs);
    if (res && res != Py_NotImplemented) {
        *out = (TfheFheUint *)malloc(sizeof(TfheFheUint));
        (*out)->obj = res;
        (*out)->bits = lhs->bits;
        rc = 0;
    } else {
        Py_XDECREF(res);
        set_error_from_python();
    }
    PyGILState_Release(st);
    return rc;
}

int tfhe_tpu_fheuint_scalar_add(TfheFheUint *l, uint64_t r, TfheFheUint **o)
{ return scalar_op(l, r, o, "__add__"); }
int tfhe_tpu_fheuint_scalar_mul(TfheFheUint *l, uint64_t r, TfheFheUint **o)
{ return scalar_op(l, r, o, "__mul__"); }
int tfhe_tpu_fheuint_scalar_shl(TfheFheUint *l, uint64_t r, TfheFheUint **o)
{ return scalar_op(l, r, o, "__lshift__"); }
int tfhe_tpu_fheuint_scalar_shr(TfheFheUint *l, uint64_t r, TfheFheUint **o)
{ return scalar_op(l, r, o, "__rshift__"); }

/* ---------------------------------------------------------------------- */

int tfhe_tpu_fheuint_serialize(TfheFheUint *ct, uint8_t **buf, size_t *len) {
    REQUIRE_INIT();
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = 1;
    PyObject *inner = PyObject_GetAttrString(ct->obj, "ct");
    PyObject *blob = NULL;
    if (inner) {
        PyObject *fn = PyObject_GetAttrString(g_ser, "serialize_radix");
        if (fn) {
            blob = PyObject_CallFunctionObjArgs(fn, inner, NULL);
            Py_DECREF(fn);
        }
        Py_DECREF(inner);
    }
    if (blob) {
        char *data;
        Py_ssize_t n;
        if (PyBytes_AsStringAndSize(blob, &data, &n) == 0) {
            *buf = (uint8_t *)malloc((size_t)n);
            memcpy(*buf, data, (size_t)n);
            *len = (size_t)n;
            rc = 0;
        }
        Py_DECREF(blob);
    }
    if (rc) set_error_from_python();
    PyGILState_Release(st);
    return rc;
}

int tfhe_tpu_fheuint_deserialize(const uint8_t *buf, size_t len,
                                 TfheFheUint **out) {
    REQUIRE_INIT();
    PyGILState_STATE st = PyGILState_Ensure();
    int rc = 1;
    PyObject *blob = PyBytes_FromStringAndSize((const char *)buf,
                                               (Py_ssize_t)len);
    PyObject *inner = NULL, *wrapped = NULL;
    if (blob) {
        PyObject *args = Py_BuildValue("(O)", blob);
        if (args) {
            inner = module_call(g_ser, "deserialize", args, 1);
            Py_DECREF(args);
        }
        Py_DECREF(blob);
    }
    if (inner) {
        PyObject *fn = PyObject_GetAttrString(g_api, "_wrap_radix");
        if (fn) {
            wrapped = PyObject_CallFunctionObjArgs(fn, inner, NULL);
            Py_DECREF(fn);
        }
        Py_DECREF(inner);
    }
    if (wrapped) {
        *out = (TfheFheUint *)malloc(sizeof(TfheFheUint));
        (*out)->obj = wrapped;
        (*out)->bits = 0;
        rc = 0;
    }
    if (rc) set_error_from_python();
    PyGILState_Release(st);
    return rc;
}

void tfhe_tpu_buffer_destroy(uint8_t *buf, size_t len) {
    (void)len;
    free(buf);
}
