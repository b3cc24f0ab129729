// The Ed25519 verifiers' host entry in one native pass: from the caller's
// three sequences of byte strings (public keys, messages, signatures) to
// the four int32 byte columns pk (32, B), R (32, B), S (32, B) and
// H(R || A || M) (64, B), row-major, that protocol/ed25519.py host_inputs
// copies to the device.
//
// Loaded with ctypes.PyDLL, so each call enters holding the interpreter
// lock:
// - ed25519_inputs_walk walks the three sequences once through the CPython
//   API and keeps each lane's pointers and lengths: bytes through
//   PyBytes_AS_STRING, any other bytes-like object through the buffer
//   protocol, its view held until ed25519_inputs_free. It copies each
//   sequence into a tuple (one object per sequence, none per lane), so a
//   caller's list that changes while the lock is released frees nothing the
//   pass reads. It raises ValueError for sequences of different lengths or
//   a key or signature of another width (32 and 64 bytes), TypeError for an
//   element that is not bytes-like, and the type error first.
// - ed25519_inputs_hash releases the lock and splits the lanes into
//   contiguous chunks across threads (native/sha512.cpp's rule: hardware
//   concurrency capped at 64, one thread below 512 lanes). Per lane a
//   thread puts R || A || M in its scratch buffer, grown to the longest
//   message, hashes it with the hasher sha512_batch uses (OpenSSL's SHA-512
//   where libcrypto loads, else sha512_one), and writes the digest and the
//   pk, R and S bytes as int32 straight into the columns.
//   Every lane is hashed on every call. Returns the threads used.
// - ed25519_inputs_free drops what the walk holds.
//
// The SHA-512 code and its OpenSSL binding are native/sha512.cpp's,
// included here (ops/build.py puts native/ on the include path).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <atomic>
#include <deque>
#include <new>
#include <system_error>

#include "sha512.cpp"

namespace {

struct Lane {
  const uint8_t* pk;
  const uint8_t* sig;
  const uint8_t* msg;
  uint64_t msg_len;
};

struct Walk {
  int64_t n = 0;
  PyObject* seqs[3] = {nullptr, nullptr, nullptr};  // pks, msgs, sigs as tuples
  std::vector<Lane> lanes;
  std::deque<Py_buffer> views;  // the non-bytes elements' buffers
  uint64_t hashed = 0;          // sum over lanes of 64 + len(M)
};

void release(Walk* w) {
  for (auto& v : w->views) PyBuffer_Release(&v);
  for (PyObject* s : w->seqs) Py_XDECREF(s);
  delete w;
}

// The bytes of a bytes-like object; false with the exception set.
bool bytes_of(Walk* w, PyObject* o, const uint8_t** p, Py_ssize_t* len) {
  if (PyBytes_Check(o)) {
    *p = reinterpret_cast<const uint8_t*>(PyBytes_AS_STRING(o));
    *len = PyBytes_GET_SIZE(o);
    return true;
  }
  w->views.emplace_back();
  Py_buffer& v = w->views.back();
  if (PyObject_GetBuffer(o, &v, PyBUF_SIMPLE) != 0) {
    w->views.pop_back();
    return false;
  }
  *p = static_cast<const uint8_t*>(v.buf);
  *len = v.len;
  return true;
}

bool walk_lanes(Walk* w) {
  PyObject** pks = PySequence_Fast_ITEMS(w->seqs[0]);
  PyObject** msgs = PySequence_Fast_ITEMS(w->seqs[1]);
  PyObject** sigs = PySequence_Fast_ITEMS(w->seqs[2]);
  const int64_t n = w->n;
  w->lanes.resize(n);
  bool widths_ok = true;
  for (int64_t i = 0; i < n; i++) {
    Lane& lane = w->lanes[i];
    Py_ssize_t pk_len, msg_len, sig_len;
    if (!bytes_of(w, pks[i], &lane.pk, &pk_len) || !bytes_of(w, msgs[i], &lane.msg, &msg_len) ||
        !bytes_of(w, sigs[i], &lane.sig, &sig_len))
      return false;
    widths_ok &= pk_len == 32 && sig_len == 64;
    lane.msg_len = static_cast<uint64_t>(msg_len);
    w->hashed += 64 + lane.msg_len;
  }
  if (!widths_ok) {
    PyErr_SetString(PyExc_ValueError, "every input must be 32 bytes");
    return false;
  }
  return true;
}

// OpenSSL's SHA-512 as the pass calls it. sha512_batch calls EVP_Digest
// with EVP_sha512(), which OpenSSL 3 resolves to its provider's digest again
// on every call, through a store the threads contend for. So where
// libcrypto has EVP_MD_fetch (3.x) the digest is fetched once, and each
// thread keeps one EVP_MD_CTX and hashes by Init, Update and Final. The
// same library hashes with the same code, and native/sha512.cpp's init_evp
// decides, as for sha512_batch, whether OpenSSL or sha512_one runs.
struct Openssl {
  const void* md = nullptr;
  void* (*ctx_new)() = nullptr;
  void (*ctx_free)(void*) = nullptr;
  int (*init)(void*, const void*, void*) = nullptr;
  int (*update)(void*, const void*, size_t) = nullptr;
  int (*final)(void*, unsigned char*, unsigned int*) = nullptr;
};

const Openssl& openssl() {
  static Openssl o;
  static bool tried = false;
  if (tried) return o;
  tried = true;
  init_evp();
  if (!g_evp_sha512) return o;
  void* h = dlopen("libcrypto.so.3", RTLD_NOW | RTLD_GLOBAL);
  if (!h) h = dlopen("libcrypto.so.1.1", RTLD_NOW | RTLD_GLOBAL);
  if (!h) return o;
  typedef const void* (*fetch_fn)(void*, const char*, const char*);
  auto fetch = (fetch_fn)dlsym(h, "EVP_MD_fetch");
  Openssl f;
  f.md = fetch ? fetch(nullptr, "SHA512", nullptr) : g_evp_sha512();
  f.ctx_new = (void* (*)())dlsym(h, "EVP_MD_CTX_new");
  f.ctx_free = (void (*)(void*))dlsym(h, "EVP_MD_CTX_free");
  f.init = (int (*)(void*, const void*, void*))dlsym(h, "EVP_DigestInit_ex");
  f.update = (int (*)(void*, const void*, size_t))dlsym(h, "EVP_DigestUpdate");
  f.final = (int (*)(void*, unsigned char*, unsigned int*))dlsym(h, "EVP_DigestFinal_ex");
  // every libcrypto.so.3 and .so.1.1 has these
  if (f.md && f.ctx_new && f.ctx_free && f.init && f.update && f.final) o = f;
  return o;
}

}  // namespace

extern "C" {

// A handle for ed25519_inputs_hash and ed25519_inputs_free; NULL with the
// exception set.
void* ed25519_inputs_walk(PyObject* pks, PyObject* msgs, PyObject* sigs) {
  Walk* w = new (std::nothrow) Walk;
  if (!w) return PyErr_NoMemory();
  PyObject* in[3] = {pks, msgs, sigs};
  for (int k = 0; k < 3; k++) {
    w->seqs[k] = PySequence_Tuple(in[k]);
    if (!w->seqs[k]) {
      release(w);
      return nullptr;
    }
  }
  w->n = PyTuple_GET_SIZE(w->seqs[0]);
  if (PyTuple_GET_SIZE(w->seqs[1]) != w->n || PyTuple_GET_SIZE(w->seqs[2]) != w->n) {
    release(w);
    PyErr_SetString(PyExc_ValueError, "pks, msgs and sigs differ in length");
    return nullptr;
  }
  bool ok;
  try {
    ok = walk_lanes(w);
  } catch (const std::bad_alloc&) {
    ok = false;
    PyErr_NoMemory();
  }
  if (!ok) {
    release(w);
    return nullptr;
  }
  return w;
}

// Fills the four columns, each (rows, n) int32; *hashed gets the bytes
// hashed. The threads used; -1 with the exception set.
int ed25519_inputs_hash(void* handle, int32_t* pk_col, int32_t* r_col, int32_t* s_col,
                        int32_t* k_col, int64_t* hashed) {
  const Walk* w = static_cast<const Walk*>(handle);
  const int64_t n = w->n;
  const Openssl& ossl = openssl();
  int nthreads = (int)std::thread::hardware_concurrency();
  nthreads = std::max(1, std::min<int>(nthreads, 64));
  if (n < 512) nthreads = 1;
  std::atomic<bool> failed{false}, hash_failed{false};
  auto work = [&](int64_t lo, int64_t hi) {
    void* ctx = ossl.md ? ossl.ctx_new() : nullptr;
    if (ossl.md && !ctx) {
      failed = true;
      return;
    }
    try {
      std::vector<uint8_t> buf;
      uint8_t digest[64];
      unsigned int sz = 64;
      for (int64_t i = lo; i < hi; i++) {
        const Lane& lane = w->lanes[i];
        const uint64_t len = 64 + lane.msg_len;
        if (buf.size() < len) buf.resize(len);
        memcpy(buf.data(), lane.sig, 32);
        memcpy(buf.data() + 32, lane.pk, 32);
        if (lane.msg_len) memcpy(buf.data() + 64, lane.msg, lane.msg_len);
        if (ctx) {
          if (!ossl.init(ctx, ossl.md, nullptr) || !ossl.update(ctx, buf.data(), len) ||
              !ossl.final(ctx, digest, &sz)) {
            hash_failed = true;
            break;
          }
        } else {
          sha512_one(buf.data(), len, digest);
        }
        for (int j = 0; j < 32; j++) {
          pk_col[j * n + i] = lane.pk[j];
          r_col[j * n + i] = lane.sig[j];
          s_col[j * n + i] = lane.sig[32 + j];
        }
        for (int j = 0; j < 64; j++) k_col[j * n + i] = digest[j];
      }
    } catch (const std::bad_alloc&) {
      failed = true;
    }
    if (ctx) ossl.ctx_free(ctx);
  };
  size_t started = 0;
  Py_BEGIN_ALLOW_THREADS
  std::vector<std::thread> ts;
  if (nthreads > 1) {
    try {
      ts.reserve(nthreads);
    } catch (const std::bad_alloc&) {
      nthreads = 1;
    }
  }
  const int64_t chunk = nthreads > 1 ? (n + nthreads - 1) / nthreads : n;
  for (int64_t lo = 0; lo < n; lo += chunk) {
    const int64_t hi = std::min<int64_t>(n, lo + chunk);
    if (nthreads == 1) {
      work(lo, hi);
      continue;
    }
    try {
      ts.emplace_back(work, lo, hi);
    } catch (const std::system_error&) {
      work(lo, hi);  // no thread to be had: this chunk in the calling thread
    }
  }
  for (auto& t : ts) t.join();
  started = ts.size();
  Py_END_ALLOW_THREADS
  if (failed) {
    PyErr_NoMemory();
    return -1;
  }
  if (hash_failed) {
    PyErr_SetString(PyExc_RuntimeError, "OpenSSL's SHA-512 failed");
    return -1;
  }
  *hashed = (int64_t)w->hashed;
  return std::max<int>(1, (int)started);
}

void ed25519_inputs_free(void* handle) {
  if (handle) release(static_cast<Walk*>(handle));
}
}
