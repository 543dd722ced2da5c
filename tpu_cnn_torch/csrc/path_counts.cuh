// Host-side counts of the code paths a library's launchers chose: each
// launcher adds one to every path its launch takes, where it launches;
// nothing on the device changes. A library exports them as
//
//     extern "C" int <library>_paths(const char** names,
//                                    unsigned long long* hits, int n)
//
// (the first n names and counts, in the order of its table; returns how
// many it has), which ops/_build.py's path_counts reads: the kernel cases
// and the sanitizer lane report the paths the launches really took, from
// the plan the launcher made.

#pragma once

#include <atomic>

namespace {

template <int N>
class PathCounts {
 public:
  explicit PathCounts(const char* const (&names)[N]) : names_(names) {}

  void add(int path) { hits_[path].fetch_add(1, std::memory_order_relaxed); }

  int read(const char** names, unsigned long long* hits, int n) const {
    for (int i = 0; i < N && i < n; ++i) {
      names[i] = names_[i];
      hits[i] = hits_[i].load(std::memory_order_relaxed);
    }
    return N;
  }

 private:
  const char* const (&names_)[N];
  std::atomic<unsigned long long> hits_[N] = {};
};

}  // namespace
