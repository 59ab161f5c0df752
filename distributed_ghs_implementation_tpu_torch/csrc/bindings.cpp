// The Python entry points of the kernel library: the module _ghs_kernels.
//
// One METH_FASTCALL function per ghs_* launcher takes the launcher's
// arguments as Python ints (device index, data pointers, sizes, the raw
// stream handle) and returns its cudaError_t as an int. A ctypes call costs
// about a microsecond more than this for the same six arguments, and a
// wrapper call is only some ten microseconds in all, so the binding is a
// CPython extension, built from Python.h alone: no PyTorch header, so it
// compiles in seconds.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstring>

extern "C" {
int ghs_gather_key(int device, const void* fragment, const void* src, const void* dst,
                   const void* rank, void* fsrc, void* key, long long e, void* stream);
int ghs_hook_compress(int device, const void* has, const void* dst_frag, const void* fragment,
                      void* new_fragment, void* parent, void* scratch, long long n,
                      int num_jumps, int form, void* stream);
int ghs_probe(int device, const void* table, const void* idx, void* out, long long count,
              void* stream);
int ghs_ell_level(int device, const void* fragment, void* out, const void* desc, long long count,
                  long long tiles, int row_indexed, void* stream);
int ghs_gather(int device, const void* table, const void* idx, void* out, long long count,
               void* stream);
const char* ghs_error_string(int code);
}

namespace {

union Arg {
  long long i;
  void* p;
};

// Reads args into out by kinds: 'i' an integer, 'p' a pointer.
bool parse(const char* name, const char* kinds, PyObject* const* args, Py_ssize_t nargs,
           Arg* out) {
  const Py_ssize_t want = (Py_ssize_t)strlen(kinds);
  if (nargs != want) {
    PyErr_Format(PyExc_TypeError, "%s takes %zd arguments, got %zd", name, want, nargs);
    return false;
  }
  for (Py_ssize_t k = 0; k < nargs; ++k) {
    if (kinds[k] == 'p') {
      out[k].p = PyLong_AsVoidPtr(args[k]);
    } else {
      out[k].i = PyLong_AsLongLong(args[k]);
    }
  }
  return !PyErr_Occurred();
}

PyObject* gather_key(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  Arg a[9];
  if (!parse("gather_key", "ippppppip", args, nargs, a)) return nullptr;
  return PyLong_FromLong(
      ghs_gather_key((int)a[0].i, a[1].p, a[2].p, a[3].p, a[4].p, a[5].p, a[6].p, a[7].i, a[8].p));
}

PyObject* hook_compress(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  Arg a[11];
  if (!parse("hook_compress", "ippppppiiip", args, nargs, a)) return nullptr;
  return PyLong_FromLong(ghs_hook_compress((int)a[0].i, a[1].p, a[2].p, a[3].p, a[4].p, a[5].p,
                                           a[6].p, a[7].i, (int)a[8].i, (int)a[9].i, a[10].p));
}

PyObject* probe(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  Arg a[6];
  if (!parse("probe", "ipppip", args, nargs, a)) return nullptr;
  return PyLong_FromLong(ghs_probe((int)a[0].i, a[1].p, a[2].p, a[3].p, a[4].i, a[5].p));
}

// desc points at the plan's bucket descriptors in host memory; the
// launcher copies them into the kernel's parameters.
PyObject* ell_level(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  Arg a[8];
  if (!parse("ell_level", "ipppiiip", args, nargs, a)) return nullptr;
  return PyLong_FromLong(ghs_ell_level((int)a[0].i, a[1].p, a[2].p, a[3].p, a[4].i, a[5].i,
                                       (int)a[6].i, a[7].p));
}

PyObject* gather(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  Arg a[6];
  if (!parse("gather", "ipppip", args, nargs, a)) return nullptr;
  return PyLong_FromLong(ghs_gather((int)a[0].i, a[1].p, a[2].p, a[3].p, a[4].i, a[5].p));
}

PyObject* error_string(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  Arg a[1];
  if (!parse("error_string", "i", args, nargs, a)) return nullptr;
  return PyUnicode_FromString(ghs_error_string((int)a[0].i));
}

#define GHS_METHOD(fn) {#fn, (PyCFunction)(void (*)(void))fn, METH_FASTCALL, nullptr}

PyMethodDef kMethods[] = {
    GHS_METHOD(gather_key), GHS_METHOD(hook_compress), GHS_METHOD(probe),
    GHS_METHOD(ell_level), GHS_METHOD(gather), GHS_METHOD(error_string),
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_ghs_kernels", nullptr, -1, kMethods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__ghs_kernels() { return PyModule_Create(&kModule); }
