// CPython-aware helpers, loaded with ctypes.PyDLL (GIL held for every
// call, so touching PyObject* is safe).  The sole client today is
// ops/kmers_native._parent_span: probing whether a list of ndarrays is a
// run of consecutive contiguous views into one parent buffer costs
// ~1.2 us/array from Python (every data-pointer access builds a ctypes or
// __array_interface__ object) but ~15 ns/array here.
//
// numpy C API use requires the API table import — callers must invoke
// pyh_init() once (returns 0 on success) before pyh_span_probe.
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#define PY_ARRAY_UNIQUE_SYMBOL savont_pyhelpers_ARRAY_API
#include <numpy/arrayobject.h>

extern "C" int pyh_init() { return _import_array(); }

// Probe `list` (a Python list of objects) for the _batch_encode layout:
// every element a 1-D C-contiguous ndarray, all sharing ONE ndarray base
// (pointer identity), with data pointers advancing exactly by nbytes.
// On match returns 1 and fills out[0]=start ptr, out[1]=end ptr,
// out[2]=itemsize of the first array; returns 0 otherwise.  The caller
// converts pointers to base offsets via base.__array_interface__ (one
// Python-side access for the whole list).
extern "C" int pyh_span_probe(PyObject* list, int64_t* out) {
  if (!PyList_Check(list))
    return 0;
  const Py_ssize_t n = PyList_GET_SIZE(list);
  if (n == 0)
    return 0;
  PyObject* first = PyList_GET_ITEM(list, 0);
  if (!PyArray_Check(first))
    return 0;
  PyArrayObject* a0 = (PyArrayObject*)first;
  PyObject* base = PyArray_BASE(a0);
  if (base == NULL || !PyArray_Check(base))
    return 0;
  if (PyArray_NDIM((PyArrayObject*)base) != 1)
    return 0;
  const int64_t start = (int64_t)(intptr_t)PyArray_DATA(a0);
  int64_t pos = start;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* it = PyList_GET_ITEM(list, i);
    if (!PyArray_Check(it))
      return 0;
    PyArrayObject* a = (PyArrayObject*)it;
    if (PyArray_BASE(a) != base || PyArray_NDIM(a) != 1 ||
        !PyArray_IS_C_CONTIGUOUS(a))
      return 0;
    if ((int64_t)(intptr_t)PyArray_DATA(a) != pos)
      return 0;
    pos += (int64_t)PyArray_NBYTES(a);
  }
  out[0] = start;
  out[1] = pos;
  out[2] = (int64_t)PyArray_ITEMSIZE(a0);
  return 1;
}
