// Native episode loader: JPEG decode + ImageNet normalization to float32
// NHWC, with the GIL released and a std::thread pool for batch loads (own
// copy of interactron_tpu/native/fastloader.cpp).
//
// This is the port's host-side data-path accelerator: decode for a whole
// 5-frame episode happens in one native call. Resizing is not done
// natively: the precollected iTHOR frames are already at the training
// resolution (300x300), so the hot path is pure decode+normalize; other
// sizes fall back to the Python path.
//
// Exposed via the CPython C API, with no pybind11 dependency:
//   _fastloader.load_images(paths: list[str], resolution: int) -> ndarray
//       returns (N, resolution, resolution, 3) float32, normalized; raises
//       ValueError if any image has a different size (caller falls back).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <atomic>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>

#include "numpy/arrayobject.h"

namespace {

const float kMean[3] = {0.485f, 0.456f, 0.406f};
const float kStd[3] = {0.229f, 0.224f, 0.225f};

struct DecodeResult {
  bool ok = false;
  std::string error;
};

// Decode one JPEG file; write normalized float32 HWC into out (res*res*3).
DecodeResult decode_one(const std::string& path, int res, float* out) {
  DecodeResult r;
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) {
    r.error = "cannot open " + path;
    return r;
  }
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    r.error = "bad jpeg header: " + path;
    return r;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  if (w != res || h != res || cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    r.error = "size mismatch";
    return r;
  }
  std::vector<unsigned char> row(static_cast<size_t>(w) * 3);
  unsigned char* rowptr = row.data();
  const float inv255 = 1.0f / 255.0f;
  while (cinfo.output_scanline < cinfo.output_height) {
    const int y = cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &rowptr, 1);
    float* dst = out + static_cast<size_t>(y) * w * 3;
    for (int x = 0; x < w; ++x) {
      for (int c = 0; c < 3; ++c) {
        const float v = static_cast<float>(row[x * 3 + c]) * inv255;
        dst[x * 3 + c] = (v - kMean[c]) / kStd[c];
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  r.ok = true;
  return r;
}

PyObject* load_images(PyObject* /*self*/, PyObject* args) {
  PyObject* list;
  int res;
  if (!PyArg_ParseTuple(args, "Oi", &list, &res)) return nullptr;
  if (!PyList_Check(list)) {
    PyErr_SetString(PyExc_TypeError, "paths must be a list");
    return nullptr;
  }
  const Py_ssize_t n = PyList_Size(list);
  std::vector<std::string> paths;
  paths.reserve(n);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PyList_GetItem(list, i);
    const char* s = PyUnicode_AsUTF8(item);
    if (!s) return nullptr;
    paths.emplace_back(s);
  }

  npy_intp dims[4] = {n, res, res, 3};
  PyObject* arr = PyArray_SimpleNew(4, dims, NPY_FLOAT32);
  if (!arr) return nullptr;
  float* data = static_cast<float*>(PyArray_DATA(reinterpret_cast<PyArrayObject*>(arr)));
  const size_t per = static_cast<size_t>(res) * res * 3;

  std::vector<DecodeResult> results(n);
  Py_BEGIN_ALLOW_THREADS {
    const int hw = static_cast<int>(std::thread::hardware_concurrency());
    const int workers = std::max(1, std::min<int>(hw, static_cast<int>(n)));
    std::vector<std::thread> threads;
    std::atomic<int> next{0};
    auto work = [&]() {
      for (;;) {
        const int i = next.fetch_add(1);
        if (i >= n) break;
        results[i] = decode_one(paths[i], res, data + per * i);
      }
    };
    for (int t = 0; t < workers; ++t) threads.emplace_back(work);
    for (auto& t : threads) t.join();
  }
  Py_END_ALLOW_THREADS;

  for (Py_ssize_t i = 0; i < n; ++i) {
    if (!results[i].ok) {
      Py_DECREF(arr);
      PyErr_SetString(PyExc_ValueError, results[i].error.c_str());
      return nullptr;
    }
  }
  return arr;
}

PyMethodDef kMethods[] = {
    {"load_images", load_images, METH_VARARGS,
     "load_images(paths, resolution) -> (N, R, R, 3) float32 normalized"},
    {nullptr, nullptr, 0, nullptr},
};

struct PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_fastloader",
    "native JPEG episode loader", -1, kMethods,
};

}  // namespace

PyMODINIT_FUNC PyInit__fastloader(void) {
  import_array();
  return PyModule_Create(&kModule);
}
