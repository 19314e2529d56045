// The launch path of the generated kernels (B5 map/reduce and scatter,
// B6 row chains): the CUDA implementations of the ops
// exprgrad_torch::mapreduce and exprgrad_torch::rowchain.
//
// It replaces no TPU kernel: the TPU kernels it launches are
// exprgrad_tpu/backend/pallasgen.py:1804 (PallasMapReduce.lower) and :2375
// (PallasRowChain.lower), which the port generates as Triton sources
// (exprgrad_torch/ops/mapreduce.py, ops/rowchain.py).  What bounds a call
// of a small generated kernel on the H100 is the host: a launch through
// Triton's Python launcher costs tens of microseconds, several times the
// kernel.  So Triton compiles each generated source once, at its first
// call (that call runs in Python, the op exprgrad_torch::generated_first),
// and hands this library the compiled function and a launch table
// (exprgrad_torch/utils/launcher.py): the buffers a call allocates, and
// the steps, each a launch with its grid, block, shared memory and
// argument slots, or a scatter's grouping of its keys (a stable sort,
// then searchsorted).  Every later call finds the table by its spec
// string and device and runs it here: no Python, one cuLaunchKernel a
// kernel on the current stream (a CUDA graph capture sees it), the
// outputs allocated by PyTorch's caching allocator.
//
// The CUDA driver API is read from libcuda with dlsym, so the library
// needs no CUDA header: it is built with the host compiler against
// PyTorch's headers alone (exprgrad_torch/utils/kernels.py).  Nothing
// here falls back: a refused launch, an operand on another device or of
// another type raises with the generated file's name.

#include <ATen/EmptyTensor.h>
#include <ATen/core/Tensor.h>
#include <ATen/core/dispatch/Dispatcher.h>
#include <ATen/ops/arange.h>
#include <ATen/ops/searchsorted.h>
#include <ATen/ops/sort.h>
#include <ATen/ops/zeros.h>
#include <c10/core/Allocator.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <torch/library.h>

#include <dlfcn.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

// --- the CUDA driver API, by dlsym ---------------------------------------
using CUresult = int;
using CUfunction = void*;
using CUstream = void*;
using CUcontext = void*;
using CUdevice = int;
using LaunchKernelFn = CUresult (*)(CUfunction, unsigned, unsigned, unsigned,
                                    unsigned, unsigned, unsigned, unsigned,
                                    CUstream, void**, void**);
using ParamInfoFn = CUresult (*)(CUfunction, size_t, size_t*, size_t*);
using ErrorStringFn = CUresult (*)(CUresult, const char**);
using CtxGetCurrentFn = CUresult (*)(CUcontext*);
using CtxSetCurrentFn = CUresult (*)(CUcontext);
using DeviceGetFn = CUresult (*)(CUdevice*, int);
using PrimaryCtxRetainFn = CUresult (*)(CUcontext*, CUdevice);

struct Driver {
  LaunchKernelFn launch = nullptr;
  ParamInfoFn param_info = nullptr;
  ErrorStringFn error_string = nullptr;
  CtxGetCurrentFn ctx_get = nullptr;
  CtxSetCurrentFn ctx_set = nullptr;
  DeviceGetFn device_get = nullptr;
  PrimaryCtxRetainFn primary_retain = nullptr;
};

const Driver& driver() {
  static const Driver d = [] {
    Driver d;
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (h == nullptr) return d;
    d.launch = reinterpret_cast<LaunchKernelFn>(dlsym(h, "cuLaunchKernel"));
    d.param_info =
        reinterpret_cast<ParamInfoFn>(dlsym(h, "cuFuncGetParamInfo"));
    d.error_string =
        reinterpret_cast<ErrorStringFn>(dlsym(h, "cuGetErrorString"));
    d.ctx_get = reinterpret_cast<CtxGetCurrentFn>(dlsym(h, "cuCtxGetCurrent"));
    d.ctx_set = reinterpret_cast<CtxSetCurrentFn>(dlsym(h, "cuCtxSetCurrent"));
    d.device_get = reinterpret_cast<DeviceGetFn>(dlsym(h, "cuDeviceGet"));
    d.primary_retain = reinterpret_cast<PrimaryCtxRetainFn>(
        dlsym(h, "cuDevicePrimaryCtxRetain_v2"));
    if (d.primary_retain == nullptr)
      d.primary_retain = reinterpret_cast<PrimaryCtxRetainFn>(
          dlsym(h, "cuDevicePrimaryCtxRetain"));
    return d;
  }();
  return d;
}

// Error messages are put together here from strings: a stream insertion
// of an integer (``c10::str``) inside this library, which is built apart
// from PyTorch, crashed at a null address in std::ostream::_M_insert
// (PyTorch 2.11 on an H100 host); ``c10::str`` of one string makes no
// stream.
std::string describe(const at::Tensor& t) {
  return std::string(c10::toString(t.scalar_type())) + " on " +
         t.device().str();
}

std::string cuda_error(CUresult r) {
  const char* text = nullptr;
  if (driver().error_string != nullptr) driver().error_string(r, &text);
  return "CUresult " + std::to_string(r) + (text ? std::string(" (") + text + ")"
                                                 : std::string());
}

// The device's primary context current on this thread, as Triton's own
// launcher makes it (a thread that has run no CUDA call has none).
void ensure_context(int device) {
  const Driver& d = driver();
  CUcontext ctx = nullptr;
  d.ctx_get(&ctx);
  if (ctx != nullptr) return;
  CUdevice dev = 0;
  CUresult r = d.device_get(&dev, device);
  if (r == 0) r = d.primary_retain(&ctx, dev);
  if (r == 0) r = d.ctx_set(ctx);
  TORCH_CHECK(r == 0, "exprgrad_torch launcher: no CUDA context on device " +
                          std::to_string(device) + ": " + cuda_error(r));
}

// --- the launch tables ---------------------------------------------------
// argument slots of a launch (utils/launcher.py SLOT)
enum Slot : int64_t { kOut = 0, kPrev = 1, kOp = 2, kBuf = 3, kEpoch = 4 };
// steps (utils/launcher.py STEP)
enum StepKind : int64_t { kLaunch = 0, kGroup = 1 };

struct Step {
  int64_t kind = kLaunch;
  // a launch
  CUfunction fn = nullptr;
  unsigned grid[3] = {1, 1, 1};
  unsigned threads = 32;
  unsigned shared = 0;
  int n_params = 0;  // the function's parameters, Triton's hidden ones too
  std::vector<std::pair<int64_t, int64_t>> slots;
  std::string name;  // the generated file and function, for errors
  // a grouping: buffer indices of the keys, sorted keys, permutation and
  // segment offsets, and the rows 0..K the offsets are searched for
  int64_t keys = 0, sorted = 0, perm = 0, offsets = 0, K = 0;
};

// a buffer's mode (utils/launcher.py BUFFER)
enum BufferMode : int64_t { kEmpty = 0, kZeros = 1, kMade = 2 };

struct Buffer {
  at::ScalarType dtype = at::kFloat;
  int64_t numel = 0;
  // kEmpty: allocated each call; kZeros: zeros made once and kept (the
  // kernel leaves them 0); kMade: a step's result (the grouping's)
  int64_t mode = kEmpty;
};

struct Kernel {
  at::ScalarType dtype = at::kFloat;
  int64_t n_out = 1;
  std::vector<bool> fresh;
  std::vector<Buffer> buffers;
  std::vector<Step> steps;
  std::vector<at::Tensor> kept;  // by buffer index (kZeros buffers only)
  at::Tensor rows;               // a grouping's rows 0..K
  std::vector<int64_t> operands;  // the op tensors the launches read
  std::string name;               // the generated file, for errors
};

struct Entry {
  std::string spec;
  std::vector<std::unique_ptr<Kernel>> devices;  // by device index
};

std::mutex g_mutex;
// hash of a spec's tail -> entries: the tail of a spec (base64 of zlib
// data) holds the data's checksum, so it tells specs apart without hashing
// the whole string every call
std::unordered_map<size_t, std::vector<std::unique_ptr<Entry>>> g_table;
std::atomic<int64_t> g_launches[2];  // mapreduce, rowchain
std::atomic<int64_t> g_first_calls{0};  // calls that found no table

size_t spec_hash(std::string_view spec) {
  size_t n = spec.size(), tail = n < 64 ? n : 64;
  return std::hash<std::string_view>()(spec.substr(n - tail)) ^
         (n * 0x9e3779b97f4a7c15ULL);
}

Kernel* find(std::string_view spec, int device) {
  std::lock_guard<std::mutex> lock(g_mutex);
  auto it = g_table.find(spec_hash(spec));
  if (it == g_table.end()) return nullptr;
  for (auto& e : it->second) {
    if (e->spec.size() == spec.size() &&
        std::memcmp(e->spec.data(), spec.data(), spec.size()) == 0) {
      if (device < 0 || device >= static_cast<int>(e->devices.size()))
        return nullptr;
      return e->devices[device].get();
    }
  }
  return nullptr;
}

// A contiguous tensor on the current CUDA device from PyTorch's CUDA
// allocator (the caching allocator, CUDA graph pools included), made
// without a trip through the dispatcher.
at::Tensor empty_cuda(at::IntArrayRef sizes, at::ScalarType dtype) {
  static c10::Allocator* const allocator =
      c10::GetAllocator(c10::DeviceType::CUDA);
  TORCH_CHECK(allocator != nullptr,
              std::string("exprgrad_torch launcher: no CUDA allocator"));
  return at::detail::empty_generic(
      sizes, allocator, c10::DispatchKeySet(c10::DispatchKey::CUDA), dtype,
      std::nullopt);
}

// ``t`` as the kernel takes it: contiguous, and 16-byte aligned as Triton
// compiled the pointer arguments (its first launch saw aligned tensors);
// a view that misses either is copied first.
at::Tensor as_operand(const at::Tensor& t) {
  at::Tensor c = t.contiguous();
  if (reinterpret_cast<uintptr_t>(c.data_ptr()) % 16 != 0)
    c = c.clone(at::MemoryFormat::Contiguous);
  return c;
}

// The first call of a spec on a device: Triton compiles and launches it in
// Python (exprgrad_torch::generated_first), which registers the table.
std::vector<at::Tensor> first_call(const char* kind, std::string_view spec,
                                   at::TensorList tensors, int64_t n_out,
                                   int64_t epoch) {
  static const c10::OperatorHandle op =
      c10::Dispatcher::singleton().findSchemaOrThrow(
          "exprgrad_torch::generated_first", "");
  c10::List<at::Tensor> list;
  list.reserve(tensors.size());
  for (const auto& t : tensors) list.push_back(t);
  torch::jit::Stack stack;
  stack.emplace_back(std::string(kind));
  stack.emplace_back(std::string(spec));
  stack.emplace_back(std::move(list));
  stack.emplace_back(n_out);
  stack.emplace_back(epoch);
  op.callBoxed(&stack);
  return stack[0].toTensorVector();
}

std::vector<at::Tensor> run(int op, std::string_view spec,
                            at::TensorList tensors, int64_t n_out,
                            int64_t epoch) {
  TORCH_CHECK(n_out >= 1 && static_cast<int64_t>(tensors.size()) >= n_out,
              "exprgrad_torch launcher: " + std::to_string(n_out) +
                  " outputs of " + std::to_string(tensors.size()) +
                  " tensors");
  const at::Tensor& first = tensors[0];
  TORCH_CHECK(first.is_cuda(),
              "exprgrad_torch launcher: tensors on " + first.device().str());
  const int device = first.get_device();
  Kernel* k = find(spec, device);
  if (k == nullptr) {
    g_first_calls.fetch_add(1);
    auto outs = first_call(op == 0 ? "mapreduce" : "rowchain", spec, tensors,
                           n_out, epoch);
    g_launches[op].fetch_add(1);
    return outs;
  }
  // every tensor is checked before anything is allocated or launched
  TORCH_CHECK(n_out == k->n_out,
              "the generated kernel " + k->name + " writes " +
                  std::to_string(k->n_out) + " outputs, not " +
                  std::to_string(n_out));
  for (int64_t i = 0; i < n_out; ++i)
    TORCH_CHECK(tensors[i].scalar_type() == k->dtype &&
                    tensors[i].device() == first.device(),
                "the generated kernel " + k->name + " cannot store " +
                    describe(tensors[i]));
  for (int64_t index : k->operands) {
    TORCH_CHECK(index < static_cast<int64_t>(tensors.size()),
                "the generated kernel " + k->name + " reads operand " +
                    std::to_string(index) + " of " +
                    std::to_string(tensors.size()));
    const at::Tensor& x = tensors[index];
    TORCH_CHECK(x.device() == first.device() && x.scalar_type() == k->dtype,
                "operand " + std::to_string(index) + " is " + describe(x) +
                    "; the kernel " + k->name + " takes " +
                    c10::toString(k->dtype) + " on " + first.device().str());
  }
  c10::DeviceGuard guard(first.device());
  ensure_context(device);
  std::vector<at::Tensor> outs(n_out), prevs(n_out);
  for (int64_t i = 0; i < n_out; ++i) {
    outs[i] = empty_cuda(tensors[i].sizes(), k->dtype);
    if (!k->fresh[i]) prevs[i] = as_operand(tensors[i]);
  }
  std::vector<at::Tensor> ops(tensors.size());
  std::vector<at::Tensor> bufs(k->buffers.size());
  for (size_t b = 0; b < k->buffers.size(); ++b) {
    const Buffer& buf = k->buffers[b];
    if (buf.mode == kZeros)
      bufs[b] = k->kept[b];
    else if (buf.mode == kEmpty)
      bufs[b] = empty_cuda({buf.numel}, buf.dtype);
  }
  auto* impl = c10::impl::getDeviceGuardImpl(c10::DeviceType::CUDA);
  CUstream stream =
      static_cast<CUstream>(impl->getStream(first.device()).native_handle());
  int32_t epoch32 = static_cast<int32_t>(epoch);
  std::vector<void*> ptrs, params;
  for (const Step& step : k->steps) {
    if (step.kind == kGroup) {
      auto sorted = at::sort(bufs[step.keys], /*stable=*/true, 0, false);
      bufs[step.sorted] = std::get<0>(sorted);
      bufs[step.perm] = std::get<1>(sorted);
      bufs[step.offsets] = at::searchsorted(
          bufs[step.sorted], k->rows,
          /*out_int32=*/bufs[step.keys].numel() <= INT32_MAX);
      continue;
    }
    ptrs.assign(step.n_params, nullptr);
    params.assign(step.n_params, nullptr);
    for (size_t s = 0; s < step.slots.size(); ++s) {
      const auto [kind, index] = step.slots[s];
      if (kind == kEpoch) {
        params[s] = &epoch32;
        continue;
      }
      const at::Tensor* t = nullptr;
      if (kind == kOut) {
        t = &outs[index];
      } else if (kind == kPrev) {
        t = &prevs[index];
      } else if (kind == kBuf) {
        t = &bufs[index];
      } else {
        if (!ops[index].defined()) ops[index] = as_operand(tensors[index]);
        t = &ops[index];
      }
      ptrs[s] = t->data_ptr();
      params[s] = &ptrs[s];
    }
    // Triton's hidden trailing parameters (scratch pointers) get null: the
    // table was registered only for functions that need no scratch
    for (size_t s = step.slots.size(); s < params.size(); ++s)
      params[s] = &ptrs[s];
    CUresult r = driver().launch(step.fn, step.grid[0], step.grid[1],
                                 step.grid[2], step.threads, 1, 1, step.shared,
                                 stream, params.data(), nullptr);
    TORCH_CHECK(r == 0, "the generated Triton kernel " + step.name +
                            " failed to launch: " + cuda_error(r));
  }
  g_launches[op].fetch_add(1);
  return outs;
}

at::Tensor mapreduce_cuda(c10::string_view spec, at::TensorList tensors,
                          int64_t epoch) {
  return run(0, std::string_view(spec.data(), spec.size()), tensors, 1,
             epoch)[0];
}

std::vector<at::Tensor> rowchain_cuda(c10::string_view spec,
                                      at::TensorList tensors, int64_t n_out,
                                      int64_t epoch) {
  return run(1, std::string_view(spec.data(), spec.size()), tensors, n_out,
             epoch);
}

}  // namespace

TORCH_LIBRARY_IMPL(exprgrad_torch, CUDA, m) {
  m.impl("mapreduce", &mapreduce_cuda);
  m.impl("rowchain", &rowchain_cuda);
}

// --- the plain C interface (ctypes, utils/launcher.py) -------------------
extern "C" {

// 0, or a bit for each driver entry point that is missing (1 the launch,
// 2 cuFuncGetParamInfo, 4 the context calls)
int egt_gen_driver() {
  const Driver& d = driver();
  return (d.launch ? 0 : 1) | (d.param_info ? 0 : 2) |
         (d.ctx_get && d.ctx_set && d.device_get && d.primary_retain ? 0 : 4);
}

// The byte size of each parameter of a loaded function, into ``sizes``
// (at most ``cap``); returns the count, -1 without cuFuncGetParamInfo.
int egt_gen_param_sizes(uint64_t fn, int64_t* sizes, int cap) {
  if (driver().param_info == nullptr) return -1;
  int n = 0;
  for (; n < cap; ++n) {
    size_t offset = 0, size = 0;
    if (driver().param_info(reinterpret_cast<CUfunction>(fn), n, &offset,
                            &size) != 0)
      break;
    sizes[n] = static_cast<int64_t>(size);
  }
  return n;
}

// Register the launch table of ``spec`` on ``device``.  ``buffers`` holds
// (dtype, numel, mode) a buffer; ``steps`` each step as
//   launch: 0, function, grid x, y, z, threads, shared bytes, parameters,
//           slots, then (slot kind, index) a slot;
//   group:  1, keys, sorted, perm, offsets (buffer indices), K;
// ``names`` the steps' names, each ended by a newline.  Returns 0, or a
// positive code for a malformed table (nothing registered then).
int egt_gen_register(const char* spec, int64_t spec_len, int device,
                     int64_t dtype, int64_t n_out, const int64_t* fresh,
                     const int64_t* buffers, int64_t n_buffers,
                     const int64_t* steps, int64_t steps_len,
                     const char* names) {
  if (device < 0 || n_out < 1) return 1;
  auto k = std::make_unique<Kernel>();
  k->dtype = static_cast<at::ScalarType>(dtype);
  k->n_out = n_out;
  for (int64_t i = 0; i < n_out; ++i) k->fresh.push_back(fresh[i] != 0);
  at::Device dev(at::kCUDA, static_cast<c10::DeviceIndex>(device));
  for (int64_t b = 0; b < n_buffers; ++b) {
    Buffer buf;
    buf.dtype = static_cast<at::ScalarType>(buffers[3 * b]);
    buf.numel = buffers[3 * b + 1];
    buf.mode = buffers[3 * b + 2];
    if (buf.mode < kEmpty || buf.mode > kMade) return 8;
    k->buffers.push_back(buf);
    k->kept.push_back(buf.mode == kZeros ? at::zeros({buf.numel}, at::TensorOptions()
                                                           .dtype(buf.dtype)
                                                           .device(dev))
                               : at::Tensor());
  }
  std::string all_names(names);
  size_t name_at = 0;
  int64_t i = 0;
  while (i < steps_len) {
    Step step;
    size_t nl = all_names.find('\n', name_at);
    if (nl == std::string::npos) return 2;
    step.name = all_names.substr(name_at, nl - name_at);
    name_at = nl + 1;
    step.kind = steps[i];
    if (step.kind == kLaunch) {
      if (i + 9 > steps_len) return 3;
      step.fn = reinterpret_cast<CUfunction>(steps[i + 1]);
      for (int g = 0; g < 3; ++g)
        step.grid[g] = static_cast<unsigned>(steps[i + 2 + g]);
      step.threads = static_cast<unsigned>(steps[i + 5]);
      step.shared = static_cast<unsigned>(steps[i + 6]);
      step.n_params = static_cast<int>(steps[i + 7]);
      int64_t n_slots = steps[i + 8];
      if (n_slots > step.n_params || i + 9 + 2 * n_slots > steps_len) return 4;
      for (int64_t s = 0; s < n_slots; ++s) {
        int64_t kind = steps[i + 9 + 2 * s], index = steps[i + 10 + 2 * s];
        bool ok = (kind == kOut || kind == kPrev) ? index < n_out
                  : kind == kBuf                  ? index < n_buffers
                                                  : kind == kOp || kind == kEpoch;
        if (!ok || index < 0) return 5;
        step.slots.emplace_back(kind, index);
        if (kind == kOp &&
            std::find(k->operands.begin(), k->operands.end(), index) ==
                k->operands.end())
          k->operands.push_back(index);
      }
      i += 9 + 2 * n_slots;
    } else if (step.kind == kGroup) {
      if (i + 6 > steps_len) return 3;
      step.keys = steps[i + 1];
      step.sorted = steps[i + 2];
      step.perm = steps[i + 3];
      step.offsets = steps[i + 4];
      step.K = steps[i + 5];
      for (int64_t b : {step.keys, step.sorted, step.perm, step.offsets})
        if (b < 0 || b >= n_buffers) return 5;
      k->rows = at::arange(step.K + 1, at::TensorOptions()
                                           .dtype(k->buffers[step.keys].dtype)
                                           .device(dev));
      i += 6;
    } else {
      return 6;
    }
    k->steps.push_back(std::move(step));
  }
  if (k->steps.empty()) return 7;
  k->name = k->steps.back().name;
  std::string_view key(spec, static_cast<size_t>(spec_len));
  std::lock_guard<std::mutex> lock(g_mutex);
  auto& bucket = g_table[spec_hash(key)];
  Entry* entry = nullptr;
  for (auto& e : bucket)
    if (e->spec == key) entry = e.get();
  if (entry == nullptr) {
    bucket.push_back(std::make_unique<Entry>());
    entry = bucket.back().get();
    entry->spec = std::string(key);
  }
  if (static_cast<int>(entry->devices.size()) <= device)
    entry->devices.resize(device + 1);
  entry->devices[device] = std::move(k);
  return 0;
}

int64_t egt_gen_launches(int op) { return g_launches[op != 0].load(); }

void egt_gen_set_launches(int op, int64_t n) { g_launches[op != 0].store(n); }

int64_t egt_gen_first_calls() { return g_first_calls.load(); }

// registered (spec, device) tables
int64_t egt_gen_registered() {
  std::lock_guard<std::mutex> lock(g_mutex);
  int64_t n = 0;
  for (auto& [hash, bucket] : g_table)
    for (auto& e : bucket)
      for (auto& k : e->devices) n += k != nullptr;
  return n;
}

}  // extern "C"
