// spmv_tpu_torch native host runtime: the planner's hot loops in C++.
//
// A copy of the stream planner's entry points of spmv_tpu/native/host.cpp
// (COO -> CSR, tile routing, the shuffle split simulation and its
// geometry helpers, slot scatter, the final-tile scan streams). The port
// keeps its own copy so that it builds and runs without the JAX package;
// the two must stay identical in what they compute, because the port's
// planner has to emit the reference planner's plan arrays bit for bit
// (tests/test_torch_plan.py pins that). The layouts it emits —
// (128,128) tiles, uint8 route stages, quota windows — are the
// reference kernels' layouts, which the port's CUDA kernels read as is.
// It also holds the merge and ELL planners' entry points. The
// reference's others (Matrix Market parsing, SpGEMM symbolic) come with
// the modules that use them.
//
// Exposed as a plain C ABI for ctypes; all buffers are allocated by
// the caller (NumPy).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// Error reporting: thread-local message buffer.
// ---------------------------------------------------------------------------
static thread_local char g_err[256];

const char* spmv_last_error() { return g_err; }

static int fail(const char* msg) {
  std::snprintf(g_err, sizeof(g_err), "%s", msg);
  return -1;
}

// ---------------------------------------------------------------------------
// COO -> CSR stable counting sort (ref semantics: load.hpp:420-474 —
// per-row input order preserved, duplicates kept).
// Caller provides all buffers: Ap (n_rows+1 int64 workspace), out_Aj,
// out_perm (the permutation so the caller can apply it to any value
// dtype without this library knowing about dtypes).
// ---------------------------------------------------------------------------
int spmv_coo_to_csr(int64_t n_rows, int64_t nnz, const int32_t* rows,
                    const int32_t* cols, int64_t* Ap, int32_t* out_Aj,
                    int64_t* out_perm) {
  std::memset(Ap, 0, sizeof(int64_t) * (size_t)(n_rows + 1));
  for (int64_t k = 0; k < nnz; ++k) {
    int32_t r = rows[k];
    if (r < 0 || r >= n_rows) return fail("row index out of range");
    ++Ap[r + 1];
  }
  for (int64_t i = 0; i < n_rows; ++i) Ap[i + 1] += Ap[i];
  // stable placement using a moving cursor per row
  int64_t* cursor = (int64_t*)std::malloc(sizeof(int64_t) * (size_t)n_rows);
  if (!cursor && n_rows > 0) return fail("out of memory (cursor)");
  std::memcpy(cursor, Ap, sizeof(int64_t) * (size_t)n_rows);
  for (int64_t k = 0; k < nnz; ++k) {
    int64_t dst = cursor[rows[k]]++;
    out_Aj[dst] = cols[k];
    out_perm[dst] = k;
  }
  std::free(cursor);
  return 0;
}

// ---------------------------------------------------------------------------
// 3-stage tile routing (the shuffle engine's plan-time core).
//
// Any within-(128,128)-tile gather out[r2,c2] = in[r1,c1] factors into
//   lane-gather(s1) -> transpose -> lane-gather(s2) -> transpose
//   -> lane-gather(s3)
// by assigning each required (r1 -> r2) flow an intermediate lane
// ("color") such that (i) per source row r1, each color carries one
// source column c1, and (ii) per destination row r2, each color is
// used at most once. With both deduped side degrees <= 128 this is a
// 128-edge-coloring of a bipartite multigraph, which exists by Konig's
// theorem and is constructed here by recursive Euler splitting (pad to
// 128-regular with dummy edges; 7 halvings; each level walks Euler
// circuits and alternates edges). This replaces, at plan time, the
// role the GPU's arbitrary shared-memory scatter/gather plays inside
// the reference's merge kernel staging (ref:
// merge_based/agent_spmv_orig.cuh:454-679).
// ---------------------------------------------------------------------------

static void euler_color_128(const uint8_t* eu, const uint8_t* ev,
                            uint8_t* group,  // in: 0s; out: color 0..127
                            int* scratch /* >= 16384*3 + 256*2 ints */) {
  const int E = 16384;
  int* order = scratch;            // E: edge ids bucketed by group
  int* adj = scratch + E;          // 2E: incident edge ids per vertex
  int* head = scratch + 3 * E;     // 257: adjacency offsets (256 verts)
  // reusable per-group state
  static thread_local unsigned char visited[16384];
  static thread_local int it[256];

  for (int level = 0; level < 7; ++level) {
    int ngroups = 1 << level;
    // bucket edges by group (counting sort over <=64 groups)
    int cnt[128] = {0};
    for (int e = 0; e < E; ++e) cnt[group[e]]++;
    int off[129];
    off[0] = 0;
    for (int g = 0; g < ngroups; ++g) off[g + 1] = off[g] + cnt[g];
    {
      int pos[128];
      std::memcpy(pos, off, sizeof(int) * ngroups);
      for (int e = 0; e < E; ++e) order[pos[group[e]]++] = e;
    }
    for (int g = 0; g < ngroups; ++g) {
      int b = off[g], n = off[g + 1] - off[g];
      if (n == 0) continue;
      // adjacency: vertex u in [0,128), vertex 128+v
      int deg[256] = {0};
      for (int i = 0; i < n; ++i) {
        int e = order[b + i];
        deg[eu[e]]++;
        deg[128 + ev[e]]++;
      }
      head[0] = 0;
      for (int vtx = 0; vtx < 256; ++vtx) head[vtx + 1] = head[vtx] + deg[vtx];
      for (int vtx = 0; vtx < 256; ++vtx) it[vtx] = head[vtx];
      {
        int pos[256];
        std::memcpy(pos, head, sizeof(int) * 256);
        for (int i = 0; i < n; ++i) {
          int e = order[b + i];
          adj[pos[eu[e]]++] = e;
          adj[pos[128 + ev[e]]++] = e;
        }
      }
      for (int i = 0; i < n; ++i) visited[order[b + i]] = 0;
      // Euler circuits: walk from each unvisited edge's left vertex;
      // with all degrees even the walk closes, alternating sides.
      for (int i = 0; i < n; ++i) {
        int e0 = order[b + i];
        if (visited[e0]) continue;
        int cur = eu[e0];
        int side = 0;
        for (;;) {
          int e = -1;
          while (it[cur] < head[cur + 1]) {
            int cand = adj[it[cur]++];
            if (!visited[cand]) { e = cand; break; }
          }
          if (e < 0) break;  // circuit closed at start vertex
          visited[e] = 1;
          group[e] = (uint8_t)(2 * g + side);
          side ^= 1;
          cur = (cur < 128) ? 128 + ev[e] : eu[e];
        }
      }
    }
  }
}

// Greedy + Kempe-chain bipartite edge coloring: colors only the LIVE
// edges (no padding to 128-regular), so sparse tiles (scan routes:
// ~2-6K edges of 16384) cost proportionally less than the Euler
// splitter's fixed 7 x O(16K). Greedy assigns the lowest color free
// at both endpoints (two uint64 masks); on conflict, Konig's
// constructive proof: pick a free at u, b free at v, flip the
// (a,b)-alternating chain starting at v (bipartite parity keeps it
// away from u), then color the edge a. Returns total flip steps
// (work diagnostic), or -1 if an edge's endpoint has no free color
// (degree > 128 — caller validated degrees, so unreachable).
static int64_t kempe_color_128(int ne, const uint8_t* eu, const uint8_t* ev,
                               uint8_t* group) {
  // per-vertex used-color masks and color->edge maps
  static thread_local uint64_t mlo[256], mhi[256];
  static thread_local int32_t cmap[256 * 128];
  std::memset(mlo, 0, sizeof(uint64_t) * 256);
  std::memset(mhi, 0, sizeof(uint64_t) * 256);
  // cmap rows touched are reset lazily via the masks (a color's map
  // entry is only read when the mask bit is set)
  int64_t flips = 0;
  for (int e = 0; e < ne; ++e) {
    int u = eu[e], v = 128 + ev[e];
    uint64_t flo = ~(mlo[u] | mlo[v]);
    uint64_t fhi = ~(mhi[u] | mhi[v]);
    int c;
    if (flo) c = __builtin_ctzll(flo);
    else if (fhi) c = 64 + __builtin_ctzll(fhi);
    else {
      // conflict: a free at u, b free at v (a used at v, b at u,
      // else greedy would have found a common color)
      uint64_t ulo = ~mlo[u], uhi = ~mhi[u];
      uint64_t vlo = ~mlo[v], vhi = ~mhi[v];
      if (!(ulo | uhi) || !(vlo | vhi)) return -1;
      int a = ulo ? __builtin_ctzll(ulo) : 64 + __builtin_ctzll(uhi);
      int b = vlo ? __builtin_ctzll(vlo) : 64 + __builtin_ctzll(vhi);
      // phase 1: walk the (a,b)-alternating path from v (first edge
      // colored a). The a/b subgraph has max degree 2 and v lacks a
      // b-edge, so this is a simple path; bipartite parity keeps it
      // away from u (arrival there would need an a-edge, and a is
      // free at u). <= 255 edges (each vertex visited once).
      static thread_local int32_t path[300];
      int plen = 0;
      int cur = v, want = a;
      for (;;) {
        uint64_t m = want < 64 ? mlo[cur] : mhi[cur];
        if (!(m & (1ull << (want & 63)))) break;  // want free at cur
        int ee = cmap[cur * 128 + want];
        path[plen++] = ee;
        if (plen >= 300) return -1;  // cannot happen (simple path)
        int u2 = eu[ee], v2 = 128 + ev[ee];
        cur = (cur == u2) ? v2 : u2;
        want = (want == a) ? b : a;
      }
      // phase 2: flip the path (edge i: a->b for even i, b->a odd).
      // Interior vertices keep both colors (masks unchanged); only
      // v (loses a, gains b) and the path's end vertex (loses its
      // last color, gains `want`, which phase 1 proved free) change.
      for (int i = 0; i < plen; ++i) {
        int ee = path[i];
        int oldc = (i & 1) ? b : a, newc = (i & 1) ? a : b;
        group[ee] = (uint8_t)newc;
        cmap[eu[ee] * 128 + newc] = ee;
        cmap[(128 + ev[ee]) * 128 + newc] = ee;
      }
      flips += plen;
      {  // v: a -> b
        uint64_t ab = 1ull << (a & 63), bb = 1ull << (b & 63);
        if (a < 64) mlo[v] &= ~ab; else mhi[v] &= ~ab;
        if (b < 64) mlo[v] |= bb; else mhi[v] |= bb;
      }
      if (plen) {  // end vertex: last old color -> `want`
        int lastold = ((plen - 1) & 1) ? b : a;
        uint64_t lb = 1ull << (lastold & 63), wb2 = 1ull << (want & 63);
        if (lastold < 64) mlo[cur] &= ~lb; else mhi[cur] &= ~lb;
        if (want < 64) mlo[cur] |= wb2; else mhi[cur] |= wb2;
      }
      if (flips > (int64_t)ne * 64) return -1;  // safety budget
      c = a;
    }
    uint64_t cb = 1ull << (c & 63);
    if (c < 64) { mlo[u] |= cb; mlo[v] |= cb; }
    else { mhi[u] |= cb; mhi[v] |= cb; }
    cmap[u * 128 + c] = e;
    cmap[v * 128 + c] = e;
    group[e] = (uint8_t)c;
  }
  return flips;
}

// src: (T,128,128) int32 flat in-tile source positions (r1*128+c1),
// -1 for don't-care slots. s1,s2,s3: (T,128,128) uint8 outputs.
// dedupe=0: caller guarantees no (r1,c1,r2) repeats (injective maps,
// e.g. shuffle split perms) — skips the 8MB stamp table whose random
// misses dominate per-tile cost. Returns 0, or -1 if a tile's deduped
// degree exceeds 128.
int spmv_route_tiles(int64_t T, const int32_t* src,
                     uint8_t* s1, uint8_t* s2, uint8_t* s3,
                     int32_t dedupe) {
  const int E = 16384;
  // triple dedupe map over (r1,c1,r2): 2M slots, epoch-stamped
  int32_t* stamp = (int32_t*)std::calloc(128 * 128 * 128, sizeof(int32_t));
  int32_t* eid = (int32_t*)std::malloc(128 * 128 * 128 * sizeof(int32_t));
  uint8_t* eu = (uint8_t*)std::malloc(E);
  uint8_t* ev = (uint8_t*)std::malloc(E);
  uint8_t* ec1 = (uint8_t*)std::malloc(E);
  uint8_t* group = (uint8_t*)std::malloc(E);
  int32_t* slot_edge = (int32_t*)std::malloc(E * sizeof(int32_t));
  int* scratch = (int*)std::malloc((3 * E + 300) * sizeof(int));
  if (!stamp || !eid || !eu || !ev || !ec1 || !group || !slot_edge || !scratch) {
    std::free(stamp); std::free(eid); std::free(eu); std::free(ev);
    std::free(ec1); std::free(group); std::free(slot_edge); std::free(scratch);
    return fail("route: out of memory");
  }
  int rc = 0;
  for (int64_t t = 0; t < T && rc == 0; ++t) {
    const int32_t* S = src + t * E;
    int32_t tstamp = (int32_t)t + 1;
    int ne = 0;
    int degl[128] = {0}, degr[128] = {0};
    for (int r2 = 0; r2 < 128 && rc == 0; ++r2) {
      for (int c2 = 0; c2 < 128; ++c2) {
        int32_t sp = S[r2 * 128 + c2];
        if (sp < 0) { slot_edge[r2 * 128 + c2] = -1; continue; }
        if (sp >= E) { rc = fail("route: src out of range"); break; }
        int r1 = sp >> 7, c1 = sp & 127;
        if (!dedupe) {
          if (degl[r1] >= 128 || degr[r2] >= 128) {
            rc = fail("route: tile degree exceeds 128 (duplicating "
                      "gather passed with dedupe=0?)");
            break;
          }
          eu[ne] = (uint8_t)r1;
          ev[ne] = (uint8_t)r2;
          ec1[ne] = (uint8_t)c1;
          degl[r1]++;
          degr[r2]++;
          slot_edge[r2 * 128 + c2] = ne++;
          continue;
        }
        int key = (sp << 7) | r2;
        if (stamp[key] != tstamp) {
          if (degl[r1] >= 128 || degr[r2] >= 128) {
            rc = fail("route: tile degree exceeds 128 (too many distinct "
                      "duplicated sources); split the gather");
            break;
          }
          stamp[key] = tstamp;
          eid[key] = ne;
          eu[ne] = (uint8_t)r1;
          ev[ne] = (uint8_t)r2;
          ec1[ne] = (uint8_t)c1;
          degl[r1]++;
          degr[r2]++;
          ++ne;
        }
        slot_edge[r2 * 128 + c2] = eid[key];
      }
    }
    if (rc != 0) break;
    // Color live edges directly (greedy + Kempe chains). Fallback:
    // pad to 128-regular and Euler-split (same result, ~4x slower)
    // if the Kempe work budget is ever exceeded.
    std::memset(group, 0, E);
    if (kempe_color_128(ne, eu, ev, group) < 0) {
      int li = 0, ri = 0;
      while (ne < E) {
        while (li < 128 && degl[li] >= 128) ++li;
        while (ri < 128 && degr[ri] >= 128) ++ri;
        if (li >= 128 || ri >= 128) { rc = fail("route: pad imbalance"); break; }
        eu[ne] = (uint8_t)li;
        ev[ne] = (uint8_t)ri;
        ec1[ne] = 0;
        degl[li]++;
        degr[ri]++;
        ++ne;
      }
      if (rc != 0) break;
      std::memset(group, 0, E);
      euler_color_128(eu, ev, group, scratch);
    }
    uint8_t* S1 = s1 + t * E;
    uint8_t* S2 = s2 + t * E;
    uint8_t* S3 = s3 + t * E;
    std::memset(S1, 0, E);
    std::memset(S2, 0, E);
    std::memset(S3, 0, E);
    for (int e = 0; e < ne; ++e) {
      int k = group[e];
      S1[eu[e] * 128 + k] = ec1[e];
      S2[k * 128 + ev[e]] = eu[e];
    }
    for (int i = 0; i < E; ++i) {
      int e = slot_edge[i];
      if (e >= 0) S3[i] = group[e];
    }
  }
  std::free(stamp); std::free(eid); std::free(eu); std::free(ev);
  std::free(ec1); std::free(group); std::free(slot_edge); std::free(scratch);
  return rc;
}

// One shuffle split pass simulation (the planner's hot loop; mirror of
// the Python loop in kernels/shuffle.py _plan_split).
//
// cur: (n_tiles*16384,) int64 payload per slot, -1 junk.
// grp: (n_tiles*16384,) int32 destination group (ignored where junk).
// B0:  (n_steps, n_groups, sbt) int64 flat output base per window.
// sort_payload: 1 -> order within each (tile, group) by ascending
//   payload (required for the FINAL pass, whose in-tile order defines
//   the scan's chunk runs); 0 -> stable slot order within groups
//   (sufficient for mid passes: feasibility and tile placement depend
//   only on per-(tile,group) counts).
// Outputs: src (n_tiles*16384 int32, -1 filled), starts
// (n_steps*sbt*n_groups int32), new_cur (out_rows*128 int64, -1
// filled). Returns 0, or -1 with the error message set.
// gmode: 0 = per-slot group comes from `grp`; 1 = mid-pass digit
// ((cur/16384)/radix) % n_groups; 2 = final-pass digit
// (cur/16384)/radix. Modes 1/2 avoid materializing the 100M-element
// group array on the Python side (page-faulted GB temporaries cost
// more than this whole simulation).
int spmv_plan_split(int64_t n_tiles, int32_t sbt, int32_t n_groups,
                    int32_t Q, int32_t sort_payload,
                    const int64_t* cur, const int32_t* grp,
                    const int64_t* B0, int64_t out_rows,
                    int32_t* src, int32_t* starts, int64_t* new_cur,
                    int32_t gmode, int64_t radix) {
  const int T = 16384, L = 128;
  if (n_groups <= 0 || n_groups > T) return fail("plan_split: bad n_groups");
  if (gmode != 0 && radix <= 0) return fail("plan_split: bad radix");
  std::memset(src, 0xFF, (size_t)n_tiles * T * sizeof(int32_t));
  std::memset(new_cur, 0xFF, (size_t)out_rows * L * sizeof(int64_t));
  int32_t* order = (int32_t*)std::malloc(T * sizeof(int32_t));
  int32_t* tmp = (int32_t*)std::malloc(T * sizeof(int32_t));
  int64_t* cnt = (int64_t*)std::malloc((n_groups + 2) * sizeof(int64_t));
  int64_t* posb = (int64_t*)std::malloc((n_groups + 2) * sizeof(int64_t));
  if (!order || !tmp || !cnt || !posb) {
    std::free(order); std::free(tmp); std::free(cnt); std::free(posb);
    return fail("plan_split: out of memory");
  }
  int rc = 0;
  // per-tile group cache: computed once for both walks below
  int32_t* gbuf = (int32_t*)std::malloc(T * sizeof(int32_t));
  if (!gbuf) {
    std::free(order); std::free(tmp); std::free(cnt); std::free(posb);
    return fail("plan_split: out of memory");
  }
  for (int64_t t = 0; t < n_tiles && rc == 0; ++t) {
    const int64_t* cur_t = cur + t * T;
    const int32_t* grp_t = grp + t * T;
    // counting sort of slot indices by effective group (junk last)
    std::memset(cnt, 0, (n_groups + 2) * sizeof(int64_t));
    for (int i = 0; i < T; ++i) {
      int g;
      if (cur_t[i] < 0) g = n_groups;
      else if (gmode == 1) g = (int)(((cur_t[i] / T) / radix) % n_groups);
      else if (gmode == 2) g = (int)((cur_t[i] / T) / radix);
      else g = grp_t[i];
      if (g < 0 || g > n_groups) { rc = fail("plan_split: group range"); break; }
      gbuf[i] = g;
      cnt[g]++;
    }
    if (rc != 0) break;
    posb[0] = 0;
    for (int g = 0; g <= n_groups; ++g) posb[g + 1] = posb[g] + cnt[g];
    int64_t n_live = posb[n_groups];
    {
      int64_t cursor[4098];
      int64_t* cp = (n_groups + 1 <= 4096)
                        ? cursor
                        : (int64_t*)std::malloc((n_groups + 2) * 8);
      std::memcpy(cp, posb, (n_groups + 1) * sizeof(int64_t));
      for (int i = 0; i < T; ++i) order[cp[gbuf[i]]++] = i;
      if (cp != cursor) std::free(cp);
    }
    if (sort_payload) {
      // within-group payload sort: LSB radix (4x8 bits) on the 32-bit
      // payload rank is overkill for <=16K elements; std::sort on the
      // group slices is simpler and fast enough for the single final
      // pass (~16K log 16K int compares).
      for (int g = 0; g < n_groups; ++g) {
        std::sort(order + posb[g], order + posb[g + 1],
                  [cur_t](int32_t a, int32_t b) {
                    return cur_t[a] < cur_t[b];
                  });
      }
    }
    int32_t* src_t = src + t * T;
    for (int64_t i = 0; i < n_live; ++i) src_t[i] = order[i];
    int64_t step = t / sbt, j = t % sbt;
    for (int g = 0; g < n_groups && rc == 0; ++g) {
      int64_t b = posb[g], c = cnt[g];
      int64_t st = b / L;
      if (st > L - Q) st = L - Q;
      if (c && (b + c) > (st + Q) * L) {
        rc = fail("split quota overflow (tile/group window)");
        break;
      }
      starts[(step * sbt + j) * n_groups + g] = (int32_t)st;
      if (c) {
        int64_t base = B0[(step * n_groups + g) * sbt + j];
        int64_t dst = base + (b - st * L);
        if (dst < 0 || dst + c > out_rows * (int64_t)L) {
          rc = fail("plan_split: destination out of range");
          break;
        }
        for (int64_t i = 0; i < c; ++i)
          new_cur[dst + i] = cur_t[order[b + i]];
      }
    }
  }
  std::free(order); std::free(tmp); std::free(cnt); std::free(posb);
  std::free(gbuf);
  return rc;
}

// ---------------------------------------------------------------------------
// Shuffle-geometry feasibility counting (plan_shuffle_auto's hot
// checks). Each quota level's exact per-window count is a bincount
// max over a derived key; at 1e8+ live elements the NumPy temporaries
// cost ~10x the arithmetic. Three primitives mirror the key chain:
//   mid1:     mid = (dt%G1)*r1 + ((st/sbt)*sbt*q1)/128
//   sub_next: gv = (dt/divg)%G;  step = mid/sbt;
//             sub = (gv*radix + step/spp)*r + ((step%spp)*sbt*q)/128
//   key_max:  max bucket count of base*mul + digit, where digit =
//             (dt/divd)%G (use_mod) or dt/divd.
// ---------------------------------------------------------------------------

int spmv_geom_mid1(int64_t n, const int32_t* dt, const int32_t* st,
                   int32_t G1, int32_t r1, int32_t q1, int32_t sbt,
                   int32_t* mid_out) {
  const int L = 128;
  for (int64_t i = 0; i < n; ++i) {
    int32_t m = (dt[i] % G1) * r1 + ((st[i] / sbt) * sbt * q1) / L;
    mid_out[i] = m;
  }
  return 0;
}

int spmv_geom_sub_next(int64_t n, const int32_t* dt, const int32_t* mid,
                       int64_t divg, int32_t G, int64_t radix,
                       int32_t spp, int32_t r, int32_t q, int32_t sbt,
                       int32_t* sub_out) {
  const int L = 128;
  for (int64_t i = 0; i < n; ++i) {
    int64_t gv = ((int64_t)dt[i] / divg) % G;
    int32_t step = mid[i] / sbt;
    sub_out[i] = (int32_t)((gv * radix + step / spp) * r
                           + ((int64_t)(step % spp) * sbt * q) / L);
  }
  return 0;
}

int64_t spmv_geom_key_max(int64_t n, const int32_t* base,
                          const int32_t* dt, int64_t mul, int64_t divd,
                          int32_t G, int32_t use_mod, int64_t n_keys) {
  int32_t* cnt = (int32_t*)std::calloc((size_t)n_keys, sizeof(int32_t));
  if (!cnt) { fail("geom_key_max: out of memory"); return -1; }
  int64_t mx = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t d = (int64_t)dt[i] / divd;
    if (use_mod) d %= G;
    int64_t k = (int64_t)base[i] * mul + d;
    if (k < 0 || k >= n_keys) {
      std::free(cnt);
      fail("geom_key_max: key out of range");
      return -1;
    }
    int32_t c = ++cnt[k];
    if (c > mx) mx = c;
  }
  std::free(cnt);
  return mx;
}

// slot_of_dst assembly: out[fin[s]] = s for live fin entries within
// range (the 1-2 GB fancy-index chain this replaces page-faults five
// temporaries at 100M nnz).
int spmv_scatter_slots(int64_t n_fin, const int64_t* fin,
                       int64_t n_out, int64_t* out) {
  std::memset(out, 0xFF, (size_t)n_out * sizeof(int64_t));
  for (int64_t s = 0; s < n_fin; ++s) {
    int64_t d = fin[s];
    if (d >= 0 && d < n_out) out[d] = s;
  }
  return 0;
}

// Scan-stream planner v3: per-final-tile EXACT-RANK streams (mirror
// of the Python loop in kernels/stream.py _plan_scan). One pass per
// tile, all O(TILE). v3 vs v2: the kernel first routes the tile's
// slots into exact rank order (positions 1..m, position 0 reserved as
// a zero prefix), which makes rel ids MONOTONE in position — every
// row is one contiguous run, so its total is S[e_r] - S[e_{r-1}] for
// ONE tile-wide cumsum S, with e_r the row's last position. That
// kills the chunk-id machinery, the C/P chunk routes and the second
// cumsum: streams are one exact-perm route, END/PREV position routes
// into the rel window, a rel-id fill (roll path only), valid2, and a
// per-tile live count (the junk mask is just position < m+1).
//
// Inputs: k_starts (F+1), bases (F, per-tile 128-aligned first row;
// rel = row - bases[f] must land in [0, bin_rows)), slot_of_dst
// (F*16384), row_ids (n_items). Outputs: perm_src/src2e/src2p
// (F*16384 i32, -1 filled), relid (F*16384 i16), valid2 (F*bin_rows
// i8), counts (F i32).
int spmv_plan_scan3(int64_t F, const int64_t* k_starts, const int64_t* bases,
                    const int64_t* slot_of_dst, const int64_t* row_ids,
                    int32_t bin_rows,
                    int32_t* perm_src, int16_t* relid_s,
                    int32_t* src2e, int32_t* src2p,
                    int8_t* valid2, int32_t* counts) {
  const int T = 16384, L = 128;
  const int P = bin_rows / L;
  if (bin_rows > T) return fail("plan_scan: bin_rows exceeds tile");
  std::memset(perm_src, 0xFF, (size_t)F * T * sizeof(int32_t));
  std::memset(src2e, 0xFF, (size_t)F * T * sizeof(int32_t));
  std::memset(src2p, 0xFF, (size_t)F * T * sizeof(int32_t));
  std::memset(valid2, 0, (size_t)F * (size_t)(P * L));
  int32_t* rank_slot = (int32_t*)std::malloc(T * sizeof(int32_t));
  if (!rank_slot) return fail("plan_scan: out of memory");
  int rc = 0;
  for (int64_t f = 0; f < F && rc == 0; ++f) {
    int64_t a = k_starts[f], b = k_starts[f + 1];
    int64_t m = b - a;
    if (m <= 0 || m > T - 1) { rc = fail("plan_scan: bad tile size"); break; }
    const int64_t* sod = slot_of_dst + f * T;
    int64_t rel_base = bases[f];
    for (int64_t i = 0; i < m; ++i) {
      int64_t sl = sod[i] - f * T;
      if (sl < 0 || sl >= T) {
        rc = fail("plan_scan: shuffle placed a rank outside its tile");
        break;
      }
      rank_slot[i] = (int32_t)sl;
    }
    if (rc != 0) break;
    counts[f] = (int32_t)m;
    int32_t* pp = perm_src + f * T;
    int32_t* s2e = src2e + f * T;
    int32_t* s2p = src2p + f * T;
    int8_t* v2 = valid2 + f * (int64_t)(P * L);
    int16_t* rl = relid_s + f * T;
    int32_t prev_rel = -1, prev_end = 0;  // position 0 = zero prefix
    int32_t rel0 = (int32_t)(row_ids[a] - rel_base);
    rl[0] = (int16_t)(rel0 + T);
    for (int64_t i = 0; i < m; ++i) {
      int32_t rel = (int32_t)(row_ids[a + i] - rel_base);
      if (rel < 0 || rel >= bin_rows) {
        rc = fail("plan_scan: rel out of bin range");
        break;
      }
      if (rel < prev_rel) {
        rc = fail("plan_scan: ranks not row-sorted within tile");
        break;
      }
      int32_t p = (int32_t)(i + 1);
      pp[p] = rank_slot[i];
      rl[p] = (int16_t)rel;
      if (rel != prev_rel) {
        if (prev_rel >= 0) {
          s2e[prev_rel] = p - 1;
          s2p[prev_rel] = prev_end;
          v2[prev_rel] = 1;
          prev_end = p - 1;
        }
        prev_rel = rel;
      }
    }
    if (rc != 0) break;
    s2e[prev_rel] = (int32_t)m;
    s2p[prev_rel] = prev_end;
    v2[prev_rel] = 1;
    // junk tail: last rel + flag (bridges the roll path's segments)
    for (int64_t p = m + 1; p < T; ++p)
      rl[p] = (int16_t)(prev_rel + T);
  }
  std::free(rank_slot);
  return rc;
}

// ---------------------------------------------------------------------------
// Merge plan construction (kernels/merge.py build_merge_plan): a greedy
// tile split bounded by nnz per tile (EN) and row span per tile (RW),
// then dense padded per-tile arrays.
//
// spmv_merge_count_tiles counts the tiles; spmv_merge_fill fills
// k_start/cnt/r_start/lrow, the source nonzero of each tile slot
// (clamped), the local row ids (non-decreasing within a tile; pads
// continue the last segment), each tile's row-end positions (-1 where a
// row has no element in the tile) and the row -> output-slot ownership
// map (the last tile touching a row; rows with no nonzeros -> T*RW).
// ---------------------------------------------------------------------------
int64_t spmv_merge_count_tiles(int64_t n_rows, int64_t nnz, const int64_t* Ap,
                               const int64_t* row_of_nnz, int64_t EN,
                               int64_t RW) {
  int64_t T = 0;
  int64_t k = 0;
  while (k < nnz) {
    int64_t r0 = row_of_nnz[k];
    int64_t r_lim = r0 + RW < n_rows ? r0 + RW : n_rows;
    int64_t k_row_limit = Ap[r_lim];
    int64_t k_next = k + EN < k_row_limit ? k + EN : k_row_limit;
    if (k_next > nnz) k_next = nnz;
    if (k_next <= k) return -1;
    ++T;
    k = k_next;
  }
  return T;
}

int spmv_merge_fill(int64_t n_rows, int64_t nnz, const int64_t* Ap,
                    const int64_t* row_of_nnz, int64_t EN, int64_t RW,
                    int64_t T,
                    // outputs (caller-allocated):
                    int64_t* k_starts,   // (T+1,)
                    int32_t* r_start,    // (T,)
                    int32_t* lrow,       // (T,)
                    int32_t* cnt,        // (T,)
                    int64_t* flat_k,     // (T*EN,) source nnz index (clamped)
                    int32_t* rel,        // (T*EN,) local row ids
                    int32_t* pend,       // (T*RW,) row-end positions or -1
                    int32_t* owner_idx   // (n_rows,) flat output slot or T*RW
) {
  int64_t k = 0, t = 0;
  while (k < nnz) {
    int64_t r0 = row_of_nnz[k];
    int64_t r_lim = r0 + RW < n_rows ? r0 + RW : n_rows;
    int64_t k_row_limit = Ap[r_lim];
    int64_t k_next = k + EN < k_row_limit ? k + EN : k_row_limit;
    if (k_next > nnz) k_next = nnz;
    if (k_next <= k || t >= T) return fail("merge fill: tile walk mismatch");
    k_starts[t] = k;
    ++t;
    k = k_next;
  }
  if (t != T) return fail("merge fill: tile count mismatch");
  k_starts[T] = nnz;

  for (int64_t i = 0; i < T; ++i) {
    int64_t ks = k_starts[i], ke = k_starts[i + 1];
    int64_t c = ke - ks;
    int64_t rs = row_of_nnz[ks];
    int64_t lr = row_of_nnz[ke - 1];
    r_start[i] = (int32_t)rs;
    lrow[i] = (int32_t)lr;
    cnt[i] = (int32_t)c;
    int64_t* fk = flat_k + i * EN;
    int32_t* rl = rel + i * EN;
    for (int64_t e = 0; e < c; ++e) {
      fk[e] = ks + e;
      rl[e] = (int32_t)(row_of_nnz[ks + e] - rs);
    }
    int32_t pad_rel = c > 0 ? rl[c - 1] : 0;
    for (int64_t e = c; e < EN; ++e) {
      fk[e] = nnz > 0 ? nnz - 1 : 0;
      rl[e] = pad_rel;
    }
    int32_t* pe = pend + i * RW;
    for (int64_t r = 0; r < RW; ++r) {
      int64_t g = rs + r;
      if (g >= n_rows) { pe[r] = -1; continue; }
      int64_t sb = Ap[g] > ks ? Ap[g] : ks;
      int64_t se = Ap[g + 1] < ke ? Ap[g + 1] : ke;
      pe[r] = (se > sb) ? (int32_t)(se - ks - 1) : -1;
    }
  }

  int64_t pad_slot = T * RW;
  for (int64_t r = 0; r < n_rows; ++r) owner_idx[r] = (int32_t)pad_slot;
  for (int64_t i = 0; i < T; ++i) {
    int64_t rs = r_start[i], le = lrow[i];
    int64_t rmax = rs + RW - 1 < le ? rs + RW - 1 : le;
    for (int64_t g = rs; g <= rmax; ++g) {
      if (Ap[g + 1] > Ap[g])  // row has nonzeros; later tiles overwrite
        owner_idx[g] = (int32_t)(i * RW + (g - rs));
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// ELL pack planning (kernels/ell.py build_ell_plan): cut each selected
// row into ceil(len / W) chunks of W slots (at least one, so an empty row
// still yields an identity chunk), emitting per-slot CSR positions
// (clamped to the last nonzero where the slot is past the row's end) so
// that the caller gathers Aj/Ax in one vectorised pass.
// ---------------------------------------------------------------------------
int64_t spmv_ell_count_chunks(int64_t n_sel, const int64_t* sel_rows,
                              const int64_t* Ap, int64_t W) {
  int64_t V = 0;
  for (int64_t i = 0; i < n_sel; ++i) {
    int64_t len = Ap[sel_rows[i] + 1] - Ap[sel_rows[i]];
    int64_t c = (len + W - 1) / W;
    V += c > 0 ? c : 1;
  }
  return V;
}

int spmv_ell_fill(int64_t n_sel, const int64_t* sel_rows, const int64_t* Ap,
                  int64_t W, int64_t V, int64_t nnz,
                  int64_t* flat_k,   // (V*W,) source positions (clamped)
                  uint8_t* valid,    // (V*W,)
                  int32_t* vrow_row  // (V,) global row per chunk
) {
  int64_t v = 0;
  for (int64_t i = 0; i < n_sel; ++i) {
    int64_t r = sel_rows[i];
    int64_t b = Ap[r], e = Ap[r + 1];
    int64_t len = e - b;
    int64_t c = (len + W - 1) / W;
    if (c == 0) c = 1;
    for (int64_t j = 0; j < c; ++j) {
      if (v >= V) return fail("ell fill: chunk overflow");
      vrow_row[v] = (int32_t)r;
      int64_t base = b + j * W;
      int64_t* fk = flat_k + v * W;
      uint8_t* vd = valid + v * W;
      for (int64_t w = 0; w < W; ++w) {
        int64_t kk = base + w;
        int ok = kk < e;
        vd[w] = (uint8_t)ok;
        fk[w] = ok ? kk : (nnz > 0 ? nnz - 1 : 0);
      }
      ++v;
    }
  }
  return v == V ? 0 : fail("ell fill: chunk count mismatch");
}

}  // extern "C"
