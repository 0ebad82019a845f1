/* The port's C ABI: the counterpart of the JAX package's
 * native/guard_ffi.c (the reference's guard-ffi crate, lib.rs:32-47:
 * run_checks + string destructor). The engine is the guard_tpu_torch
 * package, hosted in an embedded CPython interpreter, initialized once
 * and reused across calls; `run_checks` evaluates on the host.
 *
 * Its names carry the port's prefix (guard_tpu_torch_*), so this
 * library and the JAX package's can be loaded into one process.
 *
 * Build: guard_tpu_torch.ffi.build_ffi() -> libguard_tpu_torch_ffi.so
 * (and guard_tpu_torch_ffi_test, built with GUARD_FFI_TEST_MAIN).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdlib.h>
#include <string.h>

#include "guard_ffi.h"

static PyObject* g_run_checks = NULL;

static int ensure_engine(guard_extern_err_t* err) {
  if (g_run_checks != NULL) return 0;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* mod = PyImport_ImportModule("guard_tpu_torch");
  if (mod == NULL) {
    PyErr_Clear();
    PyGILState_Release(gil);
    if (err) {
      err->code = 2;
      err->message = strdup("failed to import guard_tpu_torch");
    }
    return -1;
  }
  g_run_checks = PyObject_GetAttrString(mod, "run_checks");
  Py_DECREF(mod);
  PyGILState_Release(gil);
  if (g_run_checks == NULL) {
    if (err) {
      err->code = 2;
      err->message = strdup("guard_tpu_torch.run_checks not found");
    }
    return -1;
  }
  return 0;
}

char* guard_tpu_torch_run_checks(guard_validate_input_t data,
                                 guard_validate_input_t rules, bool verbose,
                                 guard_extern_err_t* err) {
  if (err) {
    err->code = 0;
    err->message = NULL;
  }
  if (ensure_engine(err) != 0) return NULL;

  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* result = PyObject_CallFunction(
      g_run_checks, "ssiss", data.content ? data.content : "",
      rules.content ? rules.content : "", verbose ? 1 : 0,
      data.file_name ? data.file_name : "",
      rules.file_name ? rules.file_name : "");
  char* out = NULL;
  if (result == NULL) {
    PyObject *type = NULL, *value = NULL, *tb = NULL;
    PyErr_Fetch(&type, &value, &tb);
    if (err) {
      err->code = 1;
      PyObject* s = value ? PyObject_Str(value) : NULL;
      err->message = strdup(s ? PyUnicode_AsUTF8(s) : "evaluation error");
      Py_XDECREF(s);
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
  } else {
    const char* s = PyUnicode_AsUTF8(result);
    if (s != NULL) out = strdup(s);
    Py_DECREF(result);
  }
  PyGILState_Release(gil);
  return out;
}

void guard_tpu_torch_free_string(char* s) { free(s); }

#ifdef GUARD_FFI_TEST_MAIN
#include <stdio.h>
int main(void) {
  guard_validate_input_t data = {"{\"Resources\": {}}", "data.json"};
  guard_validate_input_t rules = {"Resources !empty", "rules.guard"};
  guard_extern_err_t err = {0, NULL};
  char* out = guard_tpu_torch_run_checks(data, rules, false, &err);
  if (out == NULL) {
    fprintf(stderr, "error %d: %s\n", err.code,
            err.message ? err.message : "?");
    return 1;
  }
  printf("%s\n", out);
  guard_tpu_torch_free_string(out);
  guard_tpu_torch_free_string(err.message);
  return 0;
}
#endif
