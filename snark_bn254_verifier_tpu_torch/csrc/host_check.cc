// Host build of the kernels' code, for the CPU tests only
// (tests/test_torch_csrc_host*.py): the same headers as kernels.cu, run on
// the host, so the 16<->32-bit limb conversion, the CIOS and the
// tower/curve/pairing formulas are checked without a card. K1 and its
// fused form, the G2 on-curve mask, SHA-256 and K7's inverse run lane by
// lane; K7's blocks (the PlonK lane pass) stage by stage, each thread of a
// block through a stage before the next; the team kernels (K2-K5, the
// fixed-base MSM) and K6's block stages block by block, each thread of a
// block as a fiber on the calling thread, switching to the next fiber
// wherever the card's threads meet at __syncthreads or __syncwarp.
// It is built twice, with each form of the Montgomery product
// (BN_ROLLED_CIOS, fp.cuh), so each kernel's tests run the form its unit
// runs on the card. The main path never loads this library.
#include <sys/mman.h>
#include <ucontext.h>
#include <unistd.h>

#include <algorithm>
#include <cstring>
#include <vector>

#include "g2_lines.cuh"
#include "msm_fixed.cuh"
#include "pippenger.cuh"
#include "plonk.cuh"

// The block that host_team_grid runs: a context for each of its threads
// and one for the scheduler, the running thread, and how many threads'
// bodies returned in the current round (a round runs every thread, in
// ascending tid order, from one sync to the next).
struct host_block {
  ucontext_t sched;
  std::vector<ucontext_t> fib;
  int cur, ended;
  void (*run)(void* body, int tid, long long block, uint32_t* smem);
  void* body;
  long long block;
  uint32_t* smem;
};
static thread_local host_block* running_block = nullptr;

// Ends the running thread's part of the round: on to the next thread of
// the block, after the last back to the scheduler.
static void host_block_next(host_block& b) {
  const int from = b.cur++;
  swapcontext(&b.fib[from], b.cur < (int)b.fib.size() ? &b.fib[b.cur] : &b.sched);
}

void host_block_sync() { host_block_next(*running_block); }

static void host_fiber_main() {
  host_block& b = *running_block;
  b.run(b.body, b.cur, b.block, b.smem);
  ++b.ended;
  host_block_next(b);  // never resumed
}

// Runs body(tid, block, smem) for every thread of the grid of a team
// kernel over n lanes (team threads per lane, lpb lanes per block), one
// block at a time on the same shared memory, each thread of a block a
// fiber with a stack of its own below a guard page. Returns non-zero if
// the threads of a block did not all reach the same syncs.
template <typename Body>
static int host_team_grid(long long n, int team, int lpb, long long smem_bytes, Body body) {
  constexpr size_t stack_bytes = 256 << 10;  // the kernels take a few KiB at -O1
  const size_t page = (size_t)sysconf(_SC_PAGESIZE), slot = stack_bytes + page;
  const int nthreads = team * lpb;
  const long long blocks = (n + lpb - 1) / lpb;
  std::vector<uint32_t> smem(smem_bytes / 4 + 1);
  char* stacks = (char*)mmap(nullptr, slot * nthreads, PROT_READ | PROT_WRITE,
                             MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
  if (stacks == MAP_FAILED) return 1;
  for (int tid = 0; tid < nthreads; ++tid) mprotect(stacks + tid * slot, page, PROT_NONE);
  host_block b;
  b.fib.resize(nthreads);
  b.run = [](void* p, int tid, long long block, uint32_t* s) { (*(Body*)p)(tid, block, s); };
  b.body = &body;
  b.smem = smem.data();
  running_block = &b;
  int rc = 0;
  for (b.block = 0; b.block < blocks && rc == 0; ++b.block) {
    for (int tid = 0; tid < nthreads; ++tid) {
      getcontext(&b.fib[tid]);
      b.fib[tid].uc_stack.ss_sp = stacks + tid * slot + page;
      b.fib[tid].uc_stack.ss_size = stack_bytes;
      b.fib[tid].uc_link = nullptr;
      makecontext(&b.fib[tid], host_fiber_main, 0);
    }
    do {
      b.cur = b.ended = 0;
      swapcontext(&b.sched, &b.fib[0]);
    } while (b.ended == 0);
    rc = b.ended != nthreads;
  }
  running_block = nullptr;
  munmap(stacks, slot * nthreads);
  return rc;
}

// x = x * y over (16, 12, n) Fq12 operands by team.cuh::team_mul, the Fq12
// product of K3, K4 and K5, on teams of TEAM threads, LPB lanes a block,
// with the product written over an operand as the kernels write it.
template <int TEAM, int LPB>
static int fq12_mul_team(const int32_t* a, const int32_t* b, int32_t* out, long long n) {
  constexpr long long lane_words = (12 + TEAM_SCRATCH) * 16 + 1;  // x, y, scratch
  return host_team_grid(n, TEAM, LPB, 4 * LPB * lane_words,
                        [&](int tid, long long block, uint32_t* smem) {
                          const team_t<TEAM> t = make_team<TEAM>(tid % TEAM);
                          const long long lane = block * LPB + tid / TEAM;
                          const long long src = lane < n ? lane : n - 1;
                          fq2* x = (fq2*)(smem + (tid / TEAM) * lane_words);
                          fq2 *y = x + 6, *scratch = x + 12;
                          if (t.h == 0) {
                            load_fp(x[t.k].c0, a + wcomp(t.k) * n + src, 12 * n);
                            load_fp(x[t.k].c1, a + (wcomp(t.k) + 1) * n + src, 12 * n);
                            load_fp(y[t.k].c0, b + wcomp(t.k) * n + src, 12 * n);
                            load_fp(y[t.k].c1, b + (wcomp(t.k) + 1) * n + src, 12 * n);
                          }
                          TEAM_SYNC();
                          team_mul(t, x, x, y, scratch);
                          team_store_out(t, out, n, lane, x);
                        });
}

extern "C" {

// The team's Fq12 product at K4's shape (team 12) or K3's (team 18).
int host_fq12_mul(const int32_t* a, const int32_t* b, int32_t* out, long long n, int team) {
  if (team == FE_TEAM) return fq12_mul_team<FE_TEAM, FE_LPB>(a, b, out, n);
  if (team == MM_TEAM) return fq12_mul_team<MM_TEAM, MM_LPB>(a, b, out, n);
  return 1;
}

// K1's lane, with the unrolled or the rolled CIOS (the form K2 and K5 run).
int host_mont_mul(const int32_t* a, const int32_t* b, int32_t* out,
                  long long n, int field, int rolled) {
  for (long long i = 0; i < n; ++i) {
    if (field == FQ)
      rolled ? mont_mul_lane<FQ, true>(a, b, out, n, i) : mont_mul_lane<FQ, false>(a, b, out, n, i);
    else
      rolled ? mont_mul_lane<FR, true>(a, b, out, n, i) : mont_mul_lane<FR, false>(a, b, out, n, i);
  }
  return 0;
}

// The G2 on-curve mask of kernels.cu::g2_on_curve_kernel, lane by lane.
int host_g2_on_curve(const int32_t* x, const int32_t* y, const uint8_t* inf,
                     const uint8_t* valid, uint8_t* out, long long n) {
  for (long long i = 0; i < n; ++i) out[i] = g2_on_curve_lane(x, y, inf, valid, n, i);
  return 0;
}

// The Fq inverse of Montgomery elements, by Fermat (fq_inv, K4's) or by
// the binary Euclid algorithm (fq_inv_binary, K2's).
int host_fq_inv(const int32_t* a, int32_t* out, long long n, int binary) {
  for (long long i = 0; i < n; ++i) {
    fp x, r;
    load_fp(x, a + i, n);
    if (binary)
      fq_inv_binary(r, x);
    else
      fq_inv(r, x);
    store_fp(out + i, n, r);
  }
  return 0;
}

int host_msm_affine(const int32_t* px, const int32_t* py, const uint8_t* pinf,
                    const int32_t* sc, int npts, int32_t* ox, int32_t* oy,
                    uint8_t* oinf, long long n) {
  if (npts < 1) return 1;
  return host_team_grid(n, MSM_TEAM, MSM_LPB, msm_affine_smem_bytes(),
                        [&](int tid, long long block, uint32_t* smem) {
                          msm_affine_team(tid, block, smem, px, py, pinf, sc, npts, ox, oy, oinf,
                                          n);
                        });
}

// The fixed-base MSM (msm_fixed.cuh) over its window table.
int host_msm_fixed(const int32_t* table, const int32_t* sc, int npts, int32_t* ox, int32_t* oy,
                   uint8_t* oinf, long long n) {
  if (npts < 1) return 1;
  return host_team_grid(n, FX_TEAM, FX_LPB, msm_fixed_smem_bytes(),
                        [&](int tid, long long block, uint32_t* smem) {
                          msm_fixed_team(tid, block, smem, (const uint32_t*)table, sc, npts, ox, oy,
                                         oinf, n);
                        });
}

// K6's stages (pippenger.cuh) on one scratch buffer laid out as on the
// card: host_pip_layout gives its bytes and the regions' byte offsets
// (digits, order, sdig, starts, counts, buckets, parts, flags), so a test
// can read each stage's output. The sort and the reduction run block by
// block (a fiber a card thread), the per-thread stages thread by thread,
// the combine on teams of PIP_COMB_TEAM fibers.
long long host_pip_layout(int npts, int c, long long n, int chunk, long long* off) {
  pip_scratch s;
  const long long bytes = pip_scratch_layout(&s, (char*)16, npts, c, n, chunk);
  const void* regions[8] = {s.digits, s.order, s.sdig, s.starts, s.counts, s.buckets, s.parts,
                            s.flags};
  for (int i = 0; i < 8; ++i) off[i] = (const char*)regions[i] - (const char*)16;
  return bytes;
}

static pip_scratch host_scratch(char* base, int npts, int c, long long n, int chunk) {
  pip_scratch s;
  pip_scratch_layout(&s, base, npts, c, n, chunk);
  return s;
}

// Stages 1-2: the digits and their counting sort.
int host_pip_sort(const int32_t* sc, const uint8_t* pinf, int npts, int c, int chunk,
                  char* scratch, long long n) {
  if (npts < 1 || c < 1 || c > 16 || chunk < 1) return 1;
  const pip_scratch s = host_scratch(scratch, npts, c, n, chunk);
  for (long long idx = 0; idx < n * npts; ++idx)
    pip_digits_thread(idx, sc, pinf, npts, c, s.digits, n);
  const int nt = pip_sort_threads(npts);
  return host_team_grid(n * pip_windows(c), nt, 1, pip_sort_smem_bytes(c, nt),
                        [&](int tid, long long block, uint32_t* smem) {
                          pip_sort_team(tid, nt, block, smem, npts, c, s);
                        });
}

// Stages 3-4: the chunks' bucket sums, then the merge of split runs.
int host_pip_buckets(const int32_t* px, const int32_t* py, int npts, int c, int chunk,
                     char* scratch, long long n) {
  const pip_scratch s = host_scratch(scratch, npts, c, n, chunk);
  const long long chunks = pip_chunks(npts, c, n, chunk);
  for (long long k = 0; k < chunks; ++k) pip_chunk_thread(k, chunk, px, py, npts, c, s, n);
  for (long long k = 0; k < chunks; ++k) pip_merge_thread(k, chunk, npts, c, s, n);
  return 0;
}

// Stage 5: the window sums into wsum (n, W, 24 words).
int host_pip_reduce(int npts, int c, int chunk, char* scratch, int32_t* wsum, long long n) {
  const pip_scratch s = host_scratch(scratch, npts, c, n, chunk);
  const long long rows = n * pip_windows(c);
  const int nt = pip_threads(c, rows);
  return host_team_grid(rows, nt, 1, pip_smem_bytes(nt),
                        [&](int tid, long long block, uint32_t* smem) {
                          pip_reduce_team(tid, nt, block, (g1j*)smem, npts, c, s, (uint32_t*)wsum);
                        });
}

// Stage 6: the affine sum of k sets of window sums (k, n, W, 24 words).
int host_pip_combine(const int32_t* wsum, int k, int c, int32_t* ox, int32_t* oy, uint8_t* oinf,
                     long long n) {
  if (k < 1 || c < 1 || c > 16) return 1;
  // a team a block: the teams are independent, and a host block's fibers
  // meet wherever a card's warp does
  return host_team_grid(n, PIP_COMB_TEAM, 1, 4ll * PIP_XCH_WORDS,
                        [&](int tid, long long lane, uint32_t* smem) {
                          pip_combine_team(tid, lane, true, (fp*)smem, (const uint32_t*)wsum, k,
                                           c, ox, oy, oinf, n);
                        });
}

// The whole MSM, as bn_msm_pippenger runs it on the card.
int host_msm_pippenger(const int32_t* px, const int32_t* py, const uint8_t* pinf,
                       const int32_t* sc, int npts, int c, int chunk, char* scratch,
                       int32_t* wsum, int32_t* ox, int32_t* oy, uint8_t* oinf, long long n) {
  if (host_pip_sort(sc, pinf, npts, c, chunk, scratch, n)) return 1;
  host_pip_buckets(px, py, npts, c, chunk, scratch, n);
  if (host_pip_reduce(npts, c, chunk, scratch, wsum, n)) return 1;
  return host_pip_combine(wsum, 1, c, ox, oy, oinf, n);
}

// g2_lines (g2_lines.cuh) at its shape, then K3, K4 and K5 at the
// kernels' shapes (team.cuh); K2's above (msm.cuh).
int host_g2_lines(const int32_t* px, const int32_t* py, const int32_t* qx, const int32_t* qy,
                  int32_t* out, long long n) {
  return host_team_grid(n, GL_TEAM, GL_LPB, g2_lines_smem_bytes(),
                        [&](int tid, long long block, uint32_t* smem) {
                          g2_lines_team(tid, block, smem, px, py, qx, qy, out, n);
                        });
}

int host_miller_mixed(const int32_t* vlines, const int32_t* fpx, const int32_t* fpy, int nf,
                      const int32_t* lines, const int32_t* tails, int32_t* out, long long n) {
  if (nf < 0 || nf > NF_MAX) return 1;
  return host_team_grid(n, MM_TEAM, MM_LPB, miller_mixed_smem_bytes(nf),
                        [&](int tid, long long block, uint32_t* smem) {
                          miller_mixed_team(tid, block, smem, vlines, fpx, fpy, nf, lines, tails,
                                            out, n);
                        });
}

int host_final_exp(const int32_t* f, int32_t* out, long long n) {
  return host_team_grid(n, FE_TEAM, FE_LPB, final_exp_smem_bytes(),
                        [&](int tid, long long block, uint32_t* smem) {
                          final_exp_team(tid, block, smem, f, out, n);
                        });
}

int host_miller_product(const int32_t* px, const int32_t* py, const int32_t* qx,
                        const int32_t* qy, int npairs, int32_t* out,
                        long long n) {
  if (npairs < 1) return 1;
  return host_team_grid(n, MP_TEAM * MP_CHAINS, MP_LPB, miller_product_smem_bytes(),
                        [&](int tid, long long block, uint32_t* smem) {
                          miller_product_team(tid, block, smem, px, py, qx, qy, npairs, out, n);
                        });
}

// SHA-256 of one message by sha256.cuh's streaming context, from the
// midstate ``mid`` after ``prefix`` bytes (SHA256_IV when mid is null):
// the first ``lead`` bytes a byte at a time, the rest a word at a time
// (the last part word's bytes one by one), so the words start at byte
// position lead of the block.
int host_sha256_lead(const uint8_t* msg, long long len, const uint32_t* mid, long long prefix,
                     int lead, uint8_t* out) {
  uint32_t blk[16];
  sha256_ctx c;
  sha256_start(c, mid ? mid : SHA256_IV, (uint32_t)prefix, blk, 1);
  long long i = 0;
  for (; i < lead && i < len; ++i) sha256_byte(c, msg[i]);
  std::vector<uint32_t> words((len - i + 3) / 4 + 1, 0);
  std::memcpy(words.data(), msg + i, len - i);  // little-endian memory words
  sha256_mem(c, words.data(), 1, (int)(len - i));
  const sha256_state d = sha256_final(c);
  for (int j = 0; j < 32; ++j) out[j] = (uint8_t)(d.h[j >> 2] >> (24 - 8 * (j & 3)));
  return 0;
}

int host_sha256(const uint8_t* msg, long long len, const uint32_t* mid, long long prefix,
                uint8_t* out) {
  return host_sha256_lead(msg, len, mid, prefix, 0, out);
}

// K7a's inverse (plonk.cuh::fr_inv, Bernstein-Yang divsteps) of (16, n)
// Fr limbs in Montgomery form.
int host_fr_inv(const int32_t* a, int32_t* out, long long n) {
  for (long long i = 0; i < n; ++i) {
    fp x;
    load_fp(x, a + i, n);
    store_fp(out + i, n, fr_inv(x));
  }
  return 0;
}

// K7a and K7b (plonk.cuh) as on the card: a block of K7_LPB lanes at a
// time, its stages in order, every thread of the block through a stage
// before the next (the card's __syncthreads), on the block's own shared
// memory, poisoned before each block. With ``reverse`` (the _ordered
// entries) each stage runs its threads last to first, so a stage that
// read a slot another thread writes in the same stage (a race on the
// card) fails in one order.
static void k7_block_poison(std::vector<uint32_t>& buf) {
  std::fill(buf.begin(), buf.end(), 0xA5A5A5A5u);
}

extern "C++" {
template <typename Stage>
static void k7_stage(int nthreads, int reverse, Stage stage) {
  for (int i = 0; i < nthreads; ++i) stage(reverse ? nthreads - 1 - i : i);
}
}

int host_plonk_lanes_a_ordered(const uint8_t* raw, long long L, const int32_t* pub,
                               const uint8_t* valid_in, const uint32_t* vkc, uint8_t* valid_out,
                               int32_t* zeta, int32_t* px, int32_t* py, uint8_t* pinf,
                               int32_t* lin, long long n, int reverse) {
  const k7a_args a = {raw, L, pub, valid_in, vkc, valid_out, zeta, px, py, pinf, lin, n};
  const int nt = K7A_WARPS * K7_LPB;
  std::vector<uint32_t> buf(k7a_smem_words(L, (int)vkc[PV_NB]));
  const k7_smem s = k7_layout(buf.data(), L);
  for (long long block = 0; block * K7_LPB < n; ++block) {
    k7_block_poison(buf);
    k7_stage(nt, reverse, [&](int t) { k7_stage_rows(raw, L, n, block, s, t, nt); });
    k7_stage(nt, reverse, [&](int t) { plonk_a_stage1(a, s, t, block); });
    k7_stage(nt, reverse, [&](int t) { plonk_a_stage2(a, s, t, block); });
    k7_stage(nt, reverse, [&](int t) { plonk_a_stage3(a, s, t, block); });
  }
  return 0;
}

int host_plonk_lanes_b_ordered(const uint8_t* raw, long long L, const uint8_t* valid,
                               const int32_t* zeta, const int32_t* rand, const int32_t* dx,
                               const int32_t* dy, const uint8_t* dinf, const uint32_t* vkc,
                               int32_t* sc, long long n, int reverse) {
  const k7b_args a = {raw, L, valid, zeta, rand, dx, dy, dinf, vkc, sc, n};
  const int nt = K7B_WARPS * K7_LPB;
  std::vector<uint32_t> buf(k7b_smem_words(L, (int)vkc[PV_NB]));
  const k7_smem s = k7_layout(buf.data(), L);
  for (long long block = 0; block * K7_LPB < n; ++block) {
    k7_block_poison(buf);
    k7_stage(nt, reverse, [&](int t) { k7_stage_rows(raw, L, n, block, s, t, nt); });
    k7_stage(nt, reverse, [&](int t) { plonk_b_stage1(a, s, t, block); });
    k7_stage(nt, reverse, [&](int t) { plonk_b_stage2(a, s, t, block); });
  }
  return 0;
}

// The same, first thread to last.
int host_plonk_lanes_a(const uint8_t* raw, long long L, const int32_t* pub,
                       const uint8_t* valid_in, const uint32_t* vkc, uint8_t* valid_out,
                       int32_t* zeta, int32_t* px, int32_t* py, uint8_t* pinf, int32_t* lin,
                       long long n) {
  return host_plonk_lanes_a_ordered(raw, L, pub, valid_in, vkc, valid_out, zeta, px, py, pinf,
                                    lin, n, 0);
}

int host_plonk_lanes_b(const uint8_t* raw, long long L, const uint8_t* valid,
                       const int32_t* zeta, const int32_t* rand, const int32_t* dx,
                       const int32_t* dy, const uint8_t* dinf, const uint32_t* vkc, int32_t* sc,
                       long long n) {
  return host_plonk_lanes_b_ordered(raw, L, valid, zeta, rand, dx, dy, dinf, vkc, sc, n, 0);
}

// K7's dynamic shared bytes a block over rows of L bytes with nb BSB22
// commitments (K7a's with lanes_a), and the most commitments that fit.
long long host_plonk_smem_bytes(long long L, int nb, int lanes_a) {
  return k7_smem_bytes(L, nb, lanes_a != 0);
}

int host_plonk_max_nb() { return k7_max_nb(); }

}  // extern "C"
