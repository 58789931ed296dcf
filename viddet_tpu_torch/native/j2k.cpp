// A JPEG 2000 (ISO/IEC 15444-1) codestream to RGB, as OpenJPEG 2.5 decodes
// it inside cv2.imdecode (IMREAD_COLOR).  native/jp2.py reads the JP2 boxes
// and every marker segment, refuses what this decoder does not read, and
// hands over one plan an image: the geometry, each tile's coding
// parameters after COD / COC / QCD / QCC precedence, and where its
// tile-parts' packet data lie.  Here:
//
//   tier 2   packets in the five progression orders, and their changes
//            (POC), as opj_pi_next_* walks them, packet headers (in the
//            packets or packed in PPM / PPT; tag trees for inclusion and zero
//            bit-planes, pass counts, Lblock) read as opj_t2 reads them,
//            SOP markers skipped, empty packets, precinct partitions;
//   tier 1   EBCOT's passes with the MQ decoder (Annex C, D), every
//            code-block style of Part 1 (bypass's raw passes, reset,
//            termination on each pass, vertically causal, predictable
//            termination, segmentation symbols), OpenJPEG's reconstruction
//            with half a step, an ROI's max-shift (RGN);
//   dequant  reversible: the value / 2; irreversible: times half the
//            step (1 + mant / 2048) * 2^(prec - expn) as float32;
//   DWT      the reversible 5/3 in integers, the irreversible 9/7 in
//            float32 as opj_v8dwt_decode computes each lane: K and
//            2 / K scalings, four lifting steps in OpenJPEG's order;
//   MCT      RCT, or ICT in float32; then lrintf, the DC level shift and
//            the clamp (opj_tcd_dc_level_shift_decode);
//   OpenCV   three component indices to R, G and B, each sample shifted
//            right by `shift` (the precision past 8) and saturated; under
//            `sycc`, components 0-2 taken as Y, U, V through cvtColor's
//            COLOR_YUV2BGR (its 14-bit fixed point).  Tiles go straight
//            into the output; a tile the plan lacks is left as OpenJPEG
//            leaves it, 0 in every component.
//
// No library beyond the C++ standard one.
//
// C interface (extern "C"; 0 on success, else -1 and a message in err):
//   vd_j2k_decode(codestream, size, plan, plan_len, rgb, shift, sycc, out, err, err_len)
//     out: height x width x 3 bytes.  plan (int32), see Plan below.

#include <algorithm>
#include <cmath>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <set>
#include <tuple>
#include <vector>

namespace {

struct J2kError {
  char msg[256];
};

[[noreturn]] void fail(const char* fmt, ...) __attribute__((format(printf, 1, 2)));
void fail(const char* fmt, ...) {
  J2kError e;
  va_list ap;
  va_start(ap, fmt);
  std::vsnprintf(e.msg, sizeof(e.msg), fmt, ap);
  va_end(ap);
  throw e;
}

int ceildiv(int64_t a, int64_t b) { return static_cast<int>((a + b - 1) / b); }
int ceildivpow2(int64_t a, int b) { return static_cast<int>((a + (int64_t{1} << b) - 1) >> b); }
int floordivpow2(int64_t a, int b) { return static_cast<int>(a >> b); }

// ---------------------------------------------------------------------------
// The plan native/jp2.py writes (int32):
//   ncomp, width, height, tile_w, tile_h, tiles_x, tiles_y, ntiles,
//   prec x ncomp,
//   then each tile: index, progression (0 LRCP, 1 RLCP, 2 RPCL, 3 PCRL,
//   4 CPRL), layers, mct, csty (2 SOP), nranges, (offset, length) x nranges,
//   packed (1: headers in PPM / PPT), nheaders, (offset, length) x nheaders,
//   npocs, (resolution start, component start, layer end, resolution end,
//   component end, progression) x npocs,
//   then each component: numres, cblkw, cblkh (exponents), qmfbid, guard
//   bits, code-block style, ROI shift, (ppx, ppy) x numres, (expn, mant) x
//   (3 numres - 2).

struct PlanReader {
  const int32_t* p;
  size_t n, at = 0;
  int next() {
    if (at >= n) fail("JPEG 2000 plan ends early");
    return p[at++];
  }
};

// code-block styles (COD / COC SPcod); HTJ2K (64) is refused by jp2.py
enum { kLazy = 1, kReset = 2, kTermAll = 4, kVsc = 8, kPterm = 16, kSegsym = 32,
       kDecodedStyles = 63 };

struct CompParams {
  int numres, cblkw, cblkh, qmfbid, guard, style, roishift;
  int ppx[33], ppy[33];
  int expn[97], mant[97];
};

struct Poc {  // a progression order change: resolutions r0 .. r1 - 1, and so on
  int r0, c0, l1, r1, c1, prog;
};

struct TileParams {
  int index, progression, layers, mct, csty;
  std::vector<std::pair<int64_t, int64_t>> ranges, headers;  // packet data; PPM / PPT
  bool packed = false;
  std::vector<Poc> pocs;
  std::vector<CompParams> comps;
};

// ---------------------------------------------------------------------------
// opj_bio: packet header bits, a byte after 0xFF holding 7

struct Bio {
  const uint8_t *start, *bp, *end;
  uint32_t buf = 0;
  int ct = 0;

  Bio(const uint8_t* s, const uint8_t* e) : start(s), bp(s), end(e) {}
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; --i) v |= bit() << i;
    return v;
  }
  void inalign() {
    ct = 0;
    if ((buf & 0xff) == 0xff) {
      bytein();
      ct = 0;
    }
  }
  size_t numbytes() const { return static_cast<size_t>(bp - start); }
};

// opj_tgt: a tag tree over w x h leaves, parents at (x / 2, y / 2)
struct TagTree {
  std::vector<int> value, low, parent;

  void init(int w, int h) {
    value.clear();
    low.clear();
    parent.clear();
    if (w <= 0 || h <= 0) return;
    std::vector<int> ws{w}, hs{h}, offsets{0};
    int total = w * h;
    while (ws.back() * hs.back() > 1) {
      ws.push_back((ws.back() + 1) / 2);
      hs.push_back((hs.back() + 1) / 2);
      offsets.push_back(total);
      total += ws.back() * hs.back();
    }
    value.assign(total, 999);
    low.assign(total, 0);
    parent.assign(total, -1);
    for (size_t l = 0; l + 1 < ws.size(); ++l)
      for (int y = 0; y < hs[l]; ++y)
        for (int x = 0; x < ws[l]; ++x)
          parent[offsets[l] + y * ws[l] + x] = offsets[l + 1] + (y / 2) * ws[l + 1] + x / 2;
  }

  // opj_tgt_decode: whether the leaf's value is below the threshold
  bool decode(Bio& bio, int leaf, int threshold) {
    int stack[32], depth = 0;
    int node = leaf;
    while (parent[node] >= 0) {
      if (depth >= 32) fail("JPEG 2000 tag tree too deep");
      stack[depth++] = node;
      node = parent[node];
    }
    int lo = 0;
    for (;;) {
      if (lo > low[node])
        low[node] = lo;
      else
        lo = low[node];
      while (lo < threshold && lo < value[node]) {
        if (bio.bit())
          value[node] = lo;
        else
          ++lo;
      }
      low[node] = lo;
      if (depth == 0) break;
      node = stack[--depth];
    }
    return value[node] < threshold;
  }
};

// ---------------------------------------------------------------------------
// The tile's structure, as opj_tcd_init_tile lays it out

// a code-block's terminated codeword segments (opj_tcd_seg_t): its passes
// and bytes; the bytes of every segment lie one after another in `data`
struct Seg {
  int maxpasses, passes = 0;
  uint32_t len = 0;
};

struct Cblk {
  int x0, y0, x1, y1;
  int numbps = 0, numlenbits = 0;
  bool included = false;
  std::vector<Seg> segs;
  std::vector<uint8_t> data;
};

struct Precinct {
  int x0, y0, x1, y1, cw = 0, ch = 0;
  TagTree incl, imsb;
  std::vector<Cblk> cblks;
};

struct Band {
  int orient, x0, y0, x1, y1, numbps;
  float stepsize;
  std::vector<Precinct> precincts;
  bool empty() const { return x1 <= x0 || y1 <= y0; }
};

struct Resolution {
  int x0, y0, x1, y1, pdx, pdy, pw, ph, nbands;
  Band bands[3];
};

struct TileComp {
  int x0, y0, x1, y1;
  std::vector<Resolution> res;
  std::vector<int32_t> idata;
  std::vector<float> fdata;
  int width() const { return x1 - x0; }
  int height() const { return y1 - y0; }
};

void init_tilecomp(TileComp& tc, const CompParams& cp, int prec, int tx0, int ty0, int tx1,
                   int ty1) {
  tc.x0 = tx0;  // components are not subsampled (jp2.py refuses that, as OpenCV does)
  tc.y0 = ty0;
  tc.x1 = tx1;
  tc.y1 = ty1;
  tc.res.resize(cp.numres);
  for (int r = 0; r < cp.numres; ++r) {
    Resolution& res = tc.res[r];
    const int level = cp.numres - 1 - r;
    res.x0 = ceildivpow2(tc.x0, level);
    res.y0 = ceildivpow2(tc.y0, level);
    res.x1 = ceildivpow2(tc.x1, level);
    res.y1 = ceildivpow2(tc.y1, level);
    res.pdx = cp.ppx[r];
    res.pdy = cp.ppy[r];
    const int prc_x0 = floordivpow2(res.x0, res.pdx) << res.pdx;
    const int prc_y0 = floordivpow2(res.y0, res.pdy) << res.pdy;
    const int prc_x1 = ceildivpow2(res.x1, res.pdx) << res.pdx;
    const int prc_y1 = ceildivpow2(res.y1, res.pdy) << res.pdy;
    res.pw = res.x0 == res.x1 ? 0 : (prc_x1 - prc_x0) >> res.pdx;
    res.ph = res.y0 == res.y1 ? 0 : (prc_y1 - prc_y0) >> res.pdy;
    if (static_cast<int64_t>(res.pw) * res.ph > (1 << 20)) fail("JPEG 2000 precincts past 2^20");
    int cbg_x0, cbg_y0, cbgw, cbgh;
    if (r == 0) {
      cbg_x0 = prc_x0;
      cbg_y0 = prc_y0;
      cbgw = res.pdx;
      cbgh = res.pdy;
    } else {
      cbg_x0 = ceildivpow2(prc_x0, 1);
      cbg_y0 = ceildivpow2(prc_y0, 1);
      cbgw = res.pdx - 1;
      cbgh = res.pdy - 1;
    }
    const int cbw = std::min(cp.cblkw, cbgw), cbh = std::min(cp.cblkh, cbgh);
    res.nbands = r == 0 ? 1 : 3;
    for (int b = 0; b < res.nbands; ++b) {
      Band& band = res.bands[b];
      band.orient = r == 0 ? 0 : b + 1;
      const int step_index = r == 0 ? 0 : 3 * (r - 1) + b + 1;
      if (r == 0) {
        band.x0 = ceildivpow2(tc.x0, level);
        band.y0 = ceildivpow2(tc.y0, level);
        band.x1 = ceildivpow2(tc.x1, level);
        band.y1 = ceildivpow2(tc.y1, level);
      } else {
        const int xob = band.orient & 1, yob = band.orient >> 1;
        band.x0 = ceildivpow2(static_cast<int64_t>(tc.x0) - (int64_t{xob} << level), level + 1);
        band.y0 = ceildivpow2(static_cast<int64_t>(tc.y0) - (int64_t{yob} << level), level + 1);
        band.x1 = ceildivpow2(static_cast<int64_t>(tc.x1) - (int64_t{xob} << level), level + 1);
        band.y1 = ceildivpow2(static_cast<int64_t>(tc.y1) - (int64_t{yob} << level), level + 1);
      }
      const int expn = cp.expn[step_index], mant = cp.mant[step_index];
      // tcd.c: log2_gain 0 for the irreversible path (BUG_WEIRD_TWO_INVK)
      band.stepsize = static_cast<float>((1.0 + mant / 2048.0) * std::pow(2.0, prec - expn));
      band.numbps = expn + cp.guard - 1;
      band.precincts.assign(static_cast<size_t>(res.pw) * res.ph, Precinct{});
      for (int p = 0; p < res.pw * res.ph; ++p) {
        Precinct& prc = band.precincts[p];
        const int sx = cbg_x0 + (p % res.pw) * (1 << cbgw);
        const int sy = cbg_y0 + (p / res.pw) * (1 << cbgh);
        prc.x0 = std::max(sx, band.x0);
        prc.y0 = std::max(sy, band.y0);
        prc.x1 = std::min(sx + (1 << cbgw), band.x1);
        prc.y1 = std::min(sy + (1 << cbgh), band.y1);
        const int cb_x0 = floordivpow2(prc.x0, cbw) << cbw;
        const int cb_y0 = floordivpow2(prc.y0, cbh) << cbh;
        const int cb_x1 = ceildivpow2(prc.x1, cbw) << cbw;
        const int cb_y1 = ceildivpow2(prc.y1, cbh) << cbh;
        prc.cw = std::max(0, (cb_x1 - cb_x0) >> cbw);
        prc.ch = std::max(0, (cb_y1 - cb_y0) >> cbh);
        if (band.empty()) prc.cw = prc.ch = 0;
        prc.incl.init(prc.cw, prc.ch);
        prc.imsb.init(prc.cw, prc.ch);
        prc.cblks.resize(static_cast<size_t>(prc.cw) * prc.ch);
        for (int k = 0; k < prc.cw * prc.ch; ++k) {
          Cblk& c = prc.cblks[k];
          const int x = cb_x0 + (k % prc.cw) * (1 << cbw), y = cb_y0 + (k / prc.cw) * (1 << cbh);
          c.x0 = std::max(x, prc.x0);
          c.y0 = std::max(y, prc.y0);
          c.x1 = std::min(x + (1 << cbw), prc.x1);
          c.y1 = std::min(y + (1 << cbh), prc.y1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Tier 2: the packet order (opj_pi_next_lrcp ... cprl, no POC) and packets

struct Packet {
  int layer, res, comp, prec;
};

std::vector<Packet> packet_order(const TileParams& tp, const std::vector<TileComp>& tcs, int tx0,
                                 int ty0, int tx1, int ty1) {
  const int ncomp = static_cast<int>(tcs.size());
  int maxres = 0;
  for (const CompParams& c : tp.comps) maxres = std::max(maxres, c.numres);
  std::vector<Packet> out;
  std::set<std::tuple<int, int, int, int>> seen;  // opj_pi's include array, across the POC entries
  auto emit = [&](int l, int r, int c, int p) {
    if (seen.insert(std::make_tuple(l, r, c, p)).second) out.push_back({l, r, c, p});
  };
  // the position-driven orders step over the reference grid by the finest
  // precinct of components c0 .. c1 - 1, at every resolution
  auto steps = [&](int c0, int c1, uint32_t& dx, uint32_t& dy) {
    dx = dy = 0;
    for (int c = c0; c < c1; ++c)
      for (int r = 0; r < tp.comps[c].numres; ++r) {
        const Resolution& res = tcs[c].res[r];
        const int level = tp.comps[c].numres - 1 - r, sx = res.pdx + level, sy = res.pdy + level;
        if (sx < 32) dx = dx ? std::min(dx, 1u << sx) : 1u << sx;
        if (sy < 32) dy = dy ? std::min(dy, 1u << sy) : 1u << sy;
      }
    if (!dx || !dy) fail("JPEG 2000 precinct steps of 0");
  };
  // the precinct of (c, r) that starts at (x, y), or -1
  auto precinct_at = [&](int c, int r, uint32_t x, uint32_t y) -> int {
    const int numres = tp.comps[c].numres;
    if (r >= numres) return -1;
    const Resolution& res = tcs[c].res[r];
    const int level = numres - 1 - r;
    const uint32_t trx0 = ceildivpow2(tx0, level), try0 = ceildivpow2(ty0, level);
    const uint32_t trx1 = ceildivpow2(tx1, level), try1 = ceildivpow2(ty1, level);
    const int rpx = res.pdx + level, rpy = res.pdy + level;
    if (rpx >= 31 || rpy >= 31) return -1;
    if (!(y % (1u << rpy) == 0 ||
          (y == static_cast<uint32_t>(ty0) && ((uint64_t{try0} << level) % (uint64_t{1} << rpy)))))
      return -1;
    if (!(x % (1u << rpx) == 0 ||
          (x == static_cast<uint32_t>(tx0) && ((uint64_t{trx0} << level) % (uint64_t{1} << rpx)))))
      return -1;
    if (res.pw == 0 || res.ph == 0 || trx0 == trx1 || try0 == try1) return -1;
    const uint32_t prci = (ceildiv(x, int64_t{1} << level) >> res.pdx) - (trx0 >> res.pdx);
    const uint32_t prcj = (ceildiv(y, int64_t{1} << level) >> res.pdy) - (try0 >> res.pdy);
    return static_cast<int>(prci + prcj * static_cast<uint32_t>(res.pw));
  };
  auto walk = [&](uint32_t dx, uint32_t dy, auto&& body) {
    for (uint32_t y = ty0; y < static_cast<uint32_t>(ty1); y += dy - (y % dy))
      for (uint32_t x = tx0; x < static_cast<uint32_t>(tx1); x += dx - (x % dx)) body(x, y);
  };
  // one progression over resolutions r0 .. r1 - 1, components c0 .. c1 - 1
  // and layers 0 .. l1 - 1 (opj_pi_update_decode_poc: every entry from layer 0)
  auto progression = [&](const Poc& e) {
    const int r0 = e.r0, r1 = std::min(e.r1, maxres), c0 = e.c0, c1 = std::min(e.c1, ncomp);
    const int l1 = std::min(e.l1, tp.layers);
    auto layers = [&](int c, int r, int p) {
      if (p < 0) return;
      for (int l = 0; l < l1; ++l) emit(l, r, c, p);
    };
    uint32_t dx, dy;
    switch (e.prog) {
      case 0:  // LRCP
      case 1:  // RLCP
        for (int a = e.prog == 0 ? 0 : r0; a < (e.prog == 0 ? l1 : r1); ++a)
          for (int b = e.prog == 0 ? r0 : 0; b < (e.prog == 0 ? r1 : l1); ++b)
            for (int c = c0; c < c1; ++c) {
              const int r = e.prog == 0 ? b : a, l = e.prog == 0 ? a : b;
              if (r >= tp.comps[c].numres) continue;
              const Resolution& res = tcs[c].res[r];
              for (int p = 0; p < res.pw * res.ph; ++p) emit(l, r, c, p);
            }
        break;
      case 2:  // RPCL
        steps(0, ncomp, dx, dy);
        for (int r = r0; r < r1; ++r)
          walk(dx, dy, [&](uint32_t x, uint32_t y) {
            for (int c = c0; c < c1; ++c) layers(c, r, precinct_at(c, r, x, y));
          });
        break;
      case 3:  // PCRL
        steps(0, ncomp, dx, dy);
        walk(dx, dy, [&](uint32_t x, uint32_t y) {
          for (int c = c0; c < c1; ++c)
            for (int r = r0; r < std::min(r1, tp.comps[c].numres); ++r)
              layers(c, r, precinct_at(c, r, x, y));
        });
        break;
      default:  // CPRL
        for (int c = c0; c < c1; ++c) {
          steps(c, c + 1, dx, dy);
          walk(dx, dy, [&](uint32_t x, uint32_t y) {
            for (int r = r0; r < std::min(r1, tp.comps[c].numres); ++r)
              layers(c, r, precinct_at(c, r, x, y));
          });
        }
    }
  };
  if (tp.pocs.empty())
    progression({0, 0, tp.layers, maxres, ncomp, tp.progression});
  else
    for (const Poc& e : tp.pocs) progression(e);
  return out;
}

// opj_t2_getnumpasses
uint32_t numpasses(Bio& bio) {
  if (!bio.read(1)) return 1;
  if (!bio.read(1)) return 2;
  uint32_t n = bio.read(2);
  if (n != 3) return 3 + n;
  n = bio.read(5);
  if (n != 31) return 6 + n;
  return 37 + bio.read(7);
}

// opj_t2_init_seg: the passes a new segment holds under the code-block style
Seg new_segment(int style, const Seg* previous) {
  Seg seg;
  if (style & kTermAll)
    seg.maxpasses = 1;
  else if (style & kLazy)
    seg.maxpasses = !previous ? 10 : (previous->maxpasses == 1 || previous->maxpasses == 10) ? 2 : 1;
  else
    seg.maxpasses = 109;
  return seg;
}

struct Contribution {  // bytes the packet's body holds for one code-block segment
  Cblk* cblk;
  size_t seg;
  uint32_t len;
};

// one packet's header (opj_t2_read_packet_header) from data[at, end), in
// the packet or packed apart (PPM / PPT): returns the header's end, and in
// `body` the segments its body holds bytes of, in the header's order
size_t read_header(const Packet& pk, std::vector<TileComp>& tcs, const TileParams& tp,
                   const uint8_t* data, size_t at, size_t end, std::vector<Contribution>& body) {
  body.clear();
  Resolution& res = tcs[pk.comp].res[pk.res];
  Bio bio(data + at, data + end);
  if (!bio.read(1)) {  // an empty packet
    bio.inalign();
    return at + bio.numbytes();
  }
  for (int b = 0; b < res.nbands; ++b) {
    Band& band = res.bands[b];
    if (band.empty()) continue;
    Precinct& prc = band.precincts[pk.prec];
    for (int k = 0; k < prc.cw * prc.ch; ++k) {
      Cblk& c = prc.cblks[k];
      bool included;
      if (!c.included)
        included = prc.incl.decode(bio, k, pk.layer + 1);
      else
        included = bio.read(1);
      if (!included) continue;
      if (!c.included) {
        int i = 0;
        while (!prc.imsb.decode(bio, k, i)) {
          if (++i > 74) fail("JPEG 2000 zero bit-planes past 74");
        }
        c.numbps = band.numbps + 1 - i;
        c.numlenbits = 3;
        c.included = true;
      }
      int passes = static_cast<int>(numpasses(bio));
      while (bio.read(1)) {
        if (++c.numlenbits > 32) fail("JPEG 2000 Lblock past 32");
      }
      const int style = tp.comps[pk.comp].style;
      if (c.segs.empty() || c.segs.back().passes == c.segs.back().maxpasses)
        c.segs.push_back(new_segment(style, c.segs.empty() ? nullptr : &c.segs.back()));
      for (;;) {  // the passes spread over segments, a length for each
        Seg& seg = c.segs.back();
        const int n = std::min(seg.maxpasses - seg.passes, passes);
        int lg = 0;
        while ((2 << lg) <= n) ++lg;
        const int bits = c.numlenbits + lg;
        if (bits > 32) fail("JPEG 2000 code-block length of %d bits", bits);
        body.push_back({&c, c.segs.size() - 1, bio.read(bits)});
        seg.passes += n;
        passes -= n;
        if (passes <= 0) break;
        if (c.segs.size() >= 256) fail("JPEG 2000 code-block of more than 256 segments");
        c.segs.push_back(new_segment(style, &c.segs.back()));
      }
    }
  }
  bio.inalign();
  at += bio.numbytes();
  if (at > end) fail("JPEG 2000 packet header runs past the tile's data");
  if (tp.csty & 4) {  // EPH
    if (end - at >= 2 && data[at] == 0xff && data[at + 1] == 0x92) at += 2;
  }
  return at;
}

// ---------------------------------------------------------------------------
// Tier 1: the MQ decoder (Annex C) and the three passes (Annex D)

struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};
constexpr MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},
    {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0},
    {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

enum { kCtxZc = 0, kCtxSc = 9, kCtxMag = 14, kCtxAgg = 17, kCtxUni = 18, kContexts = 19 };


// opj_mqc_init_dec / opj_mqc_decode over data followed by 0xFF 0xFF
struct Mq {
  const uint8_t* bp;
  uint32_t a, c;
  int ct;
  uint8_t state[kContexts], mps[kContexts];

  void reset() {
    std::memset(state, 0, sizeof(state));
    std::memset(mps, 0, sizeof(mps));
    state[kCtxUni] = 46;
    state[kCtxAgg] = 3;
    state[kCtxZc] = 4;
  }
  void bytein() {
    if (*bp == 0xff) {
      if (bp[1] > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        ++bp;
        c += static_cast<uint32_t>(*bp) << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += static_cast<uint32_t>(*bp) << 8;
      ct = 8;
    }
  }
  // opj_mqc_raw_init_dec / opj_mqc_raw_decode: a bypassed segment's bits,
  // a byte after 0xFF holding 7
  void raw_init(const uint8_t* data) {
    bp = data;
    c = 0;
    ct = 0;
  }
  int raw() {
    if (ct == 0) {
      if (c == 0xff) {
        if (*bp > 0x8f) {
          c = 0xff;
          ct = 8;
        } else {
          c = *bp++;
          ct = 7;
        }
      } else {
        c = *bp++;
        ct = 8;
      }
    }
    --ct;
    return (c >> ct) & 1;
  }
  void init(const uint8_t* data, size_t len) {  // data[len], data[len + 1] are 0xFF
    bp = data;
    c = len == 0 ? 0xffu << 16 : static_cast<uint32_t>(*bp) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
  }
  int decode(int ctx) {
    const MqState& s = kMq[state[ctx]];
    int d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {
      if (a < s.qe) {
        a = s.qe;
        d = mps[ctx];
        state[ctx] = s.nmps;
      } else {
        a = s.qe;
        d = !mps[ctx];
        if (s.sw) mps[ctx] = !mps[ctx];
        state[ctx] = s.nlps;
      }
      renorm();
    } else {
      c -= static_cast<uint32_t>(s.qe) << 16;
      if ((a & 0x8000) == 0) {
        if (a < s.qe) {
          d = !mps[ctx];
          if (s.sw) mps[ctx] = !mps[ctx];
          state[ctx] = s.nlps;
        } else {
          d = mps[ctx];
          state[ctx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[ctx];
      }
    }
    return d;
  }
};

// Table D.1: the zero-coding context from the counts of significant
// horizontal, vertical and diagonal neighbours; OpenJPEG swaps h and v
// for its band 2 (xob 0, yob 1)
int zc_context(int h, int v, int d, int orient) {
  if (orient == 1) std::swap(h, v);
  if (orient != 3) {
    if (h == 0) {
      if (v == 0) return d == 0 ? 0 : d == 1 ? 1 : 2;
      return v == 1 ? 3 : 4;
    }
    if (h == 1) return v == 0 ? (d == 0 ? 5 : 6) : 7;
    return 8;
  }
  const int hv = h + v;
  if (d == 0) return hv == 0 ? 0 : hv == 1 ? 1 : 2;
  if (d == 1) return hv == 0 ? 3 : hv == 1 ? 4 : 5;
  if (d == 2) return hv == 0 ? 6 : 7;
  return 8;
}

// Each coefficient's flags: which of its 8 neighbours are significant and
// the signs of the 4 direct ones, kept up to date as coefficients turn
// significant, so that a context is one table look-up
constexpr uint32_t kN = 1, kS = 2, kW = 4, kE = 8, kNW = 16, kNE = 32, kSW = 64, kSE = 128;
constexpr uint32_t kSig = 1 << 8, kNeg = 1 << 9, kVisited = 1 << 10, kRefined = 1 << 11;
constexpr uint32_t kNegN = 1 << 12, kNegS = 1 << 13, kNegW = 1 << 14, kNegE = 1 << 15;

struct Luts {
  uint8_t zc[4][256];  // by band orientation and the neighbours' significance
  uint8_t sc[256];     // (N, S, W, E significance | their signs << 4) -> context | xor << 7

  Luts() {
    for (int o = 0; o < 4; ++o)
      for (int f = 0; f < 256; ++f) {
        const int h = !!(f & kW) + !!(f & kE), v = !!(f & kN) + !!(f & kS);
        const int d = !!(f & kNW) + !!(f & kNE) + !!(f & kSW) + !!(f & kSE);
        zc[o][f] = static_cast<uint8_t>(kCtxZc + zc_context(h, v, d, o));
      }
    for (int f = 0; f < 256; ++f) {
      auto part = [&](int sig, int neg) { return (f & sig) ? ((f & (neg >> 8)) ? -1 : 1) : 0; };
      int hc = part(kW, kNegW) + part(kE, kNegE), vc = part(kN, kNegN) + part(kS, kNegS);
      hc = std::max(-1, std::min(1, hc));
      vc = std::max(-1, std::min(1, vc));
      int ctx, xorbit = 0;  // Table D.3
      if (hc < 0) {
        xorbit = 1;
        hc = -hc;
        vc = -vc;
      }
      if (hc == 0) {
        if (vc < 0) {
          xorbit = 1;
          vc = -vc;
        }
        ctx = vc == 0 ? 0 : 1;
      } else {
        ctx = vc == 1 ? 4 : vc == 0 ? 3 : 2;
      }
      sc[f] = static_cast<uint8_t>((kCtxSc + ctx) | xorbit << 7);
    }
  }
};

const Luts& luts() {
  static const Luts l;
  return l;
}

struct T1 {
  int w, h, stride, style;
  const uint8_t* zc;
  std::vector<uint32_t> flags;  // (w + 2) x (h + 2), a border never significant
  std::vector<int32_t> data;
  Mq mq;

  uint32_t* f(int x, int y) { return &flags[static_cast<size_t>(y + 1) * stride + x + 1]; }
  int decode_sign(uint32_t fv) {
    const uint8_t e = luts().sc[(fv & 15) | (fv >> 8 & 0xF0)];
    return mq.decode(e & 0x7f) ^ (e >> 7);
  }
  void significant(int x, int y, int neg, int32_t oneplushalf) {
    data[static_cast<size_t>(y) * w + x] = neg ? -oneplushalf : oneplushalf;
    uint32_t* c = f(x, y);
    *c |= kSig | (neg ? kNeg : 0u);
    if ((y & 3) || !(style & kVsc)) {  // vertically causal: the stripe above never sees it
      c[-stride - 1] |= kSE;
      c[-stride] |= kS | (neg ? kNegS : 0u);
      c[-stride + 1] |= kSW;
    }
    c[-1] |= kE | (neg ? kNegE : 0u);
    c[1] |= kW | (neg ? kNegW : 0u);
    c[stride - 1] |= kNE;
    c[stride] |= kN | (neg ? kNegN : 0u);
    c[stride + 1] |= kNW;
  }

  // the passes walk stripes of 4 rows, column by column, down each column
  template <typename F>
  void stripes(F&& visit) {
    for (int k = 0; k < h; k += 4) {
      const int rows = std::min(4, h - k);
      uint32_t* c = f(0, k);
      int32_t* d = data.data() + static_cast<size_t>(k) * w;
      for (int x = 0; x < w; ++x, ++c, ++d) visit(c, d, x, k, rows);
    }
  }

  void sigpass(int bpno) {
    const int32_t oneplushalf = (1 << bpno) | ((1 << bpno) >> 1);
    stripes([&](uint32_t* c, int32_t* d, int x, int k, int rows) {
      for (int j = 0; j < rows; ++j, c += stride, d += w) {
        const uint32_t fv = *c;
        if ((fv & kSig) || !(fv & 0xFF)) continue;
        if (mq.decode(zc[fv & 0xFF])) significant(x, k + j, decode_sign(fv), oneplushalf);
        *c |= kVisited;
      }
    });
  }
  // the bypassed passes: raw bits for significance, sign and refinement
  void sigpass_raw(int bpno) {
    const int32_t oneplushalf = (1 << bpno) | ((1 << bpno) >> 1);
    stripes([&](uint32_t* c, int32_t*, int x, int k, int rows) {
      for (int j = 0; j < rows; ++j, c += stride) {
        const uint32_t fv = *c;
        if ((fv & kSig) || !(fv & 0xFF)) continue;
        if (mq.raw()) significant(x, k + j, mq.raw(), oneplushalf);
        *c |= kVisited;
      }
    });
  }
  void refpass_raw(int bpno) {
    const int32_t poshalf = (1 << bpno) >> 1;
    stripes([&](uint32_t* c, int32_t* d, int, int, int rows) {
      for (int j = 0; j < rows; ++j, c += stride, d += w) {
        if ((*c & (kSig | kVisited)) != kSig) continue;
        const int v = mq.raw();
        *d += (v ^ (*d < 0)) ? poshalf : -poshalf;
        *c |= kRefined;
      }
    });
  }
  void refpass(int bpno) {
    const int32_t poshalf = (1 << bpno) >> 1;
    stripes([&](uint32_t* c, int32_t* d, int, int, int rows) {
      for (int j = 0; j < rows; ++j, c += stride, d += w) {
        const uint32_t fv = *c;
        if ((fv & (kSig | kVisited)) != kSig) continue;
        const int ctx = (fv & kRefined) ? kCtxMag + 2 : (fv & 0xFF) ? kCtxMag + 1 : kCtxMag;
        const int v = mq.decode(ctx);
        *d += (v ^ (*d < 0)) ? poshalf : -poshalf;
        *c = fv | kRefined;
      }
    });
  }
  void clnpass(int bpno) {
    const int32_t oneplushalf = (1 << bpno) | ((1 << bpno) >> 1);
    constexpr uint32_t kBusy = kSig | kVisited | 0xFF;
    stripes([&](uint32_t* c, int32_t*, int x, int k, int rows) {
      int j = 0;
      // run-length mode on a full column with nothing in or around it
      if (rows == 4 && !((c[0] | c[stride] | c[2 * stride] | c[3 * stride]) & kBusy)) {
        if (!mq.decode(kCtxAgg)) return;
        j = mq.decode(kCtxUni);
        j = j << 1 | mq.decode(kCtxUni);
        significant(x, k + j, decode_sign(c[j * stride]), oneplushalf);
        ++j;
      }
      for (; j < rows; ++j) {
        uint32_t* cj = c + j * stride;
        if (*cj & (kSig | kVisited)) {
          *cj &= ~static_cast<uint32_t>(kVisited);
          continue;
        }
        if (mq.decode(zc[*cj & 0xFF])) significant(x, k + j, decode_sign(*cj), oneplushalf);
      }
    });
    if (style & kSegsym)  // opj_t1_dec_clnpass_check_segsym: four symbols, not checked
      for (int i = 0; i < 4; ++i) mq.decode(kCtxUni);
  }

  // opj_t1_decode_cblk: each segment from its own start, MQ-coded or, under
  // bypass, raw for the significance and refinement passes from the fifth
  // bit-plane on (predictable termination changes nothing the decoder
  // reads); then the ROI's magnitudes shifted back
  void decode(Cblk& c, int orient, int style_, int roishift) {
    w = c.x1 - c.x0;
    h = c.y1 - c.y0;
    stride = w + 2;
    style = style_;
    zc = luts().zc[orient];
    flags.assign(static_cast<size_t>(w + 2) * (h + 2), 0);
    data.assign(static_cast<size_t>(w) * h, 0);
    if (c.segs.empty()) return;
    int bpno_plus_one = roishift + c.numbps;
    if (bpno_plus_one >= 31) fail("JPEG 2000 code-block of %d bit-planes", bpno_plus_one);
    mq.reset();
    int passtype = 2;
    size_t at = 0;
    std::vector<uint8_t> buf;
    for (const Seg& seg : c.segs) {
      const bool raw = (style & kLazy) && passtype < 2 && bpno_plus_one <= c.numbps - 4;
      buf.assign(c.data.begin() + at, c.data.begin() + at + seg.len);
      buf.push_back(0xff);  // the 0xFF 0xFF OpenJPEG puts after a segment
      buf.push_back(0xff);
      at += seg.len;
      if (raw)
        mq.raw_init(buf.data());
      else
        mq.init(buf.data(), seg.len);
      for (int pass = 0; pass < seg.passes && bpno_plus_one >= 1; ++pass) {
        if (passtype == 0)
          raw ? sigpass_raw(bpno_plus_one) : sigpass(bpno_plus_one);
        else if (passtype == 1)
          raw ? refpass_raw(bpno_plus_one) : refpass(bpno_plus_one);
        else
          clnpass(bpno_plus_one);
        if ((style & kReset) && !raw) mq.reset();
        if (++passtype == 3) {
          passtype = 0;
          --bpno_plus_one;
        }
      }
    }
    if (roishift >= 31) {
      std::fill(data.begin(), data.end(), 0);
    } else if (roishift) {  // opj_t1_clbl_decode_processor
      const int32_t thresh = 1 << roishift;
      for (int32_t& v : data) {
        const int32_t mag = v < 0 ? -v : v;
        if (mag >= thresh) v = v < 0 ? -(mag >> roishift) : mag >> roishift;
      }
    }
  }
};

// ---------------------------------------------------------------------------
// The inverse transforms

// opj_v8dwt_decode on one lane: E holds low samples at cas + 2i and high
// ones at 1 - cas + 2i
void lift97(float* e, int p, int end, int m, float c) {
  const int imax = std::min(end, m);
  for (int i = 0; i < imax; ++i) {
    const int at = p + 2 * i;
    const float left = at - 1 >= 0 ? e[at - 1] : e[at + 1];
    e[at] = e[at] + (left + e[at + 1]) * c;
  }
  if (m < end) {
    const int at = p + 2 * imax;
    e[at] = e[at] + (c + c) * e[at - 1];
  }
}

void idwt97_1d(float* e, int sn, int dn, int cas) {
  constexpr float kAlpha = -1.586134342f, kBeta = -0.052980118f, kGamma = 0.882911075f,
                  kDelta = 0.443506852f, kK = 1.230174105f, kTwoInvK = 1.625732422f;
  int a, b;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
    a = 0;
    b = 1;
  } else {
    if (!(sn > 0 || dn > 1)) return;
    a = 1;
    b = 0;
  }
  for (int i = 0; i < sn; ++i) e[a + 2 * i] *= kK;
  for (int i = 0; i < dn; ++i) e[b + 2 * i] *= kTwoInvK;
  lift97(e, a, sn, std::min(sn, dn - a), -kDelta);
  lift97(e, b, dn, std::min(dn, sn - b), -kGamma);
  lift97(e, a, sn, std::min(sn, dn - a), -kBeta);
  lift97(e, b, dn, std::min(dn, sn - b), -kAlpha);
}

// the reversible 5/3 (F.3.8) with symmetric extension, cas the parity of the
// first sample
void idwt53_1d(int32_t* e, int sn, int dn, int cas) {
  const int n = sn + dn;
  if (n == 1) {
    if (cas) e[0] /= 2;  // opj_idwt53_h's one-sample case
    return;
  }
  auto at = [&](int i) {  // mirrored index
    if (i < 0) i = -i;
    if (i >= n) i = 2 * (n - 1) - i;
    return i;
  };
  // even positions of the signal (absolute index parity) are low samples
  const int first_low = cas;  // position in e of the first low sample
  for (int i = first_low; i < n; i += 2) e[i] -= (e[at(i - 1)] + e[at(i + 1)] + 2) >> 2;
  for (int i = 1 - first_low; i < n; i += 2) e[i] += (e[at(i - 1)] + e[at(i + 1)]) >> 1;
}

template <typename T, typename F>
void idwt_2d(std::vector<T>& buf, const TileComp& tc, F&& one_d) {
  const int w = tc.width();
  std::vector<T> line;
  for (size_t r = 1; r < tc.res.size(); ++r) {
    const Resolution &lo = tc.res[r - 1], &hi = tc.res[r];
    const int rw = hi.x1 - hi.x0, rh = hi.y1 - hi.y0;
    const int sw = lo.x1 - lo.x0, shh = lo.y1 - lo.y0;
    line.resize(static_cast<size_t>(std::max(rw, rh)) + 2);
    const int cas_h = hi.x0 % 2, cas_v = hi.y0 % 2;
    for (int y = 0; y < rh; ++y) {
      T* row = buf.data() + static_cast<size_t>(y) * w;
      for (int i = 0; i < sw; ++i) line[cas_h + 2 * i] = row[i];
      for (int i = 0; i < rw - sw; ++i) line[1 - cas_h + 2 * i] = row[sw + i];
      one_d(line.data(), sw, rw - sw, cas_h);
      std::copy(line.begin(), line.begin() + rw, row);
    }
    for (int x = 0; x < rw; ++x) {
      T* col = buf.data() + x;
      for (int i = 0; i < shh; ++i) line[cas_v + 2 * i] = col[static_cast<size_t>(i) * w];
      for (int i = 0; i < rh - shh; ++i)
        line[1 - cas_v + 2 * i] = col[static_cast<size_t>(shh + i) * w];
      one_d(line.data(), shh, rh - shh, cas_v);
      for (int i = 0; i < rh; ++i) col[static_cast<size_t>(i) * w] = line[i];
    }
  }
}

// ---------------------------------------------------------------------------

uint8_t sat(int32_t v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// color_yuv's YCrCb2RGB_i with the YUV coefficients (cvtColor's COLOR_YUV2BGR),
// in place on one pixel's Y, U, V
void yuv_to_rgb(uint8_t* o) {
  auto descale = [](int32_t x) { return (x + (1 << 13)) >> 14; };
  const int32_t y = o[0], u = o[1] - 128, v = o[2] - 128;
  o[0] = sat(y + descale(v * 18678));
  o[1] = sat(y + descale(u * -6472 + v * -9519));
  o[2] = sat(y + descale(u * 33292));
}

// where decoded tiles go: RGB of width pixels a row, components rgb[0..2]
// shifted right by `shift`, sYCC converted
struct Output {
  uint8_t* pixels;
  const int* rgb;
  int shift;
  bool sycc;
};

void decode_tile(const uint8_t* cs, size_t size, const TileParams& tp, const int* prec, int ncomp,
                 int width, int height, int tile_w, int tile_h, int tiles_x, const Output& out) {
  const int p = tp.index % tiles_x, q = tp.index / tiles_x;
  const int tx0 = p * tile_w, ty0 = q * tile_h;
  const int tx1 = std::min(tx0 + tile_w, width), ty1 = std::min(ty0 + tile_h, height);
  std::vector<TileComp> tcs(ncomp);
  for (int c = 0; c < ncomp; ++c) init_tilecomp(tcs[c], tp.comps[c], prec[c], tx0, ty0, tx1, ty1);
  // the tile-parts' packet data, in order
  std::vector<uint8_t> data;
  for (const auto& [off, len] : tp.ranges) {
    if (off < 0 || len < 0 || static_cast<uint64_t>(off) + len > size)
      fail("JPEG 2000 tile-part past the codestream");
    data.insert(data.end(), cs + off, cs + off + len);
  }
  std::vector<uint8_t> packed;  // the packet headers of PPM / PPT, in order
  for (const auto& [off, len] : tp.headers) {
    if (off < 0 || len < 0 || static_cast<uint64_t>(off) + len > size)
      fail("JPEG 2000 packed packet headers past the codestream");
    packed.insert(packed.end(), cs + off, cs + off + len);
  }
  size_t at = 0, hat = 0;
  std::vector<Contribution> body;
  for (const Packet& pk : packet_order(tp, tcs, tx0, ty0, tx1, ty1)) {
    if (tp.csty & 2) {  // SOP, in the packet: skipped where present, as OpenJPEG warns where not
      if (data.size() - at >= 6 && data[at] == 0xff && data[at + 1] == 0x91) at += 6;
    }
    if (tp.packed)
      hat = read_header(pk, tcs, tp, packed.data(), hat, packed.size(), body);
    else
      at = read_header(pk, tcs, tp, data.data(), at, data.size(), body);
    for (const Contribution& b : body) {  // opj_t2_read_packet_data
      if (b.len > data.size() - at) fail("JPEG 2000 code-block data runs past the tile's data");
      b.cblk->data.insert(b.cblk->data.end(), data.begin() + at, data.begin() + at + b.len);
      b.cblk->segs[b.seg].len += b.len;
      at += b.len;
    }
  }
  // tier 1, then dequantisation into each band's place in the tile-component
  T1 t1;
  for (int c = 0; c < ncomp; ++c) {
    TileComp& tc = tcs[c];
    const CompParams& cp = tp.comps[c];
    const size_t n = static_cast<size_t>(tc.width()) * tc.height();
    const bool rev = cp.qmfbid == 1;
    if (rev)
      tc.idata.assign(n, 0);
    else
      tc.fdata.assign(n, 0.0f);
    for (size_t r = 0; r < tc.res.size(); ++r) {
      Resolution& res = tc.res[r];
      for (int b = 0; b < res.nbands; ++b) {
        Band& band = res.bands[b];
        const float step = 0.5f * band.stepsize;
        for (Precinct& prc : band.precincts)
          for (Cblk& cb : prc.cblks) {
            if (cb.x1 <= cb.x0 || cb.y1 <= cb.y0) continue;
            t1.decode(cb, band.orient, cp.style, cp.roishift);
            int x = cb.x0 - band.x0, y = cb.y0 - band.y0;
            if (band.orient & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
            if (band.orient & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
            for (int j = 0; j < t1.h; ++j)
              for (int i = 0; i < t1.w; ++i) {
                const int32_t v = t1.data[static_cast<size_t>(j) * t1.w + i];
                const size_t o = static_cast<size_t>(y + j) * tc.width() + x + i;
                if (rev)
                  tc.idata[o] = v / 2;
                else
                  tc.fdata[o] = static_cast<float>(v) * step;
              }
          }
      }
    }
    if (rev)
      idwt_2d(tc.idata, tc, idwt53_1d);
    else
      idwt_2d(tc.fdata, tc, idwt97_1d);
  }
  if (tp.mct && ncomp >= 3) {  // opj_tcd_mct_decode skips it over fewer components
    const size_t n = static_cast<size_t>(tcs[0].width()) * tcs[0].height();
    if (tp.comps[0].qmfbid == 1) {  // opj_mct_decode
      int32_t *c0 = tcs[0].idata.data(), *c1 = tcs[1].idata.data(), *c2 = tcs[2].idata.data();
      for (size_t i = 0; i < n; ++i) {
        const int32_t y = c0[i], u = c1[i], v = c2[i];
        const int32_t g = y - ((u + v) >> 2);
        c0[i] = v + g;
        c1[i] = g;
        c2[i] = u + g;
      }
    } else {  // opj_mct_decode_real
      float *c0 = tcs[0].fdata.data(), *c1 = tcs[1].fdata.data(), *c2 = tcs[2].fdata.data();
      for (size_t i = 0; i < n; ++i) {
        const float y = c0[i], u = c1[i], v = c2[i];
        c0[i] = y + (v * 1.402f);
        c1[i] = y - (u * 0.34413f) - (v * 0.71414f);
        c2[i] = y + (u * 1.772f);
      }
    }
  }
  // opj_tcd_dc_level_shift_decode, into the tile's planes
  std::vector<std::vector<int32_t>> planes(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    const TileComp& tc = tcs[c];
    const int32_t shift = 1 << (prec[c] - 1), hi = static_cast<int32_t>((1u << prec[c]) - 1);
    std::vector<int32_t>& plane = planes[c];
    plane.resize(static_cast<size_t>(tc.width()) * tc.height());
    for (size_t i = 0; i < plane.size(); ++i) {
      int64_t v;
      if (tp.comps[c].qmfbid == 1) {
        v = static_cast<int64_t>(tc.idata[i]) + shift;
      } else {
        const float f = tc.fdata[i];
        if (f > static_cast<float>(INT32_MAX))
          v = hi;
        else if (f < static_cast<float>(INT32_MIN))
          v = 0;
        else
          v = static_cast<int64_t>(std::lrintf(f)) + shift;
      }
      plane[i] = static_cast<int32_t>(std::min<int64_t>(std::max<int64_t>(v, 0), hi));
    }
  }
  // OpenCV's copyToMat: each sample >> shift, saturated to 8 bits; sYCC then
  // converted
  const int w = tx1 - tx0;
  for (int y = ty0; y < ty1; ++y)
    for (int x = tx0; x < tx1; ++x) {
      const size_t i = static_cast<size_t>(y - ty0) * w + (x - tx0);
      uint8_t* o = out.pixels + (static_cast<size_t>(y) * width + x) * 3;
      for (int k = 0; k < 3; ++k) o[k] = sat(planes[out.rgb[k]][i] >> out.shift);
      if (out.sycc) yuv_to_rgb(o);
    }
}

void decode(const uint8_t* cs, size_t size, const int32_t* plan, size_t plan_len, const int* rgb,
            int shift, int sycc, uint8_t* out) {
  PlanReader pr{plan, plan_len};
  const int ncomp = pr.next(), width = pr.next(), height = pr.next();
  const int tile_w = pr.next(), tile_h = pr.next(), tiles_x = pr.next(), tiles_y = pr.next();
  const int ntiles = pr.next();
  if (ncomp < 1 || ncomp > 4 || width <= 0 || height <= 0 || tile_w <= 0 || tile_h <= 0 ||
      tiles_x <= 0 || tiles_y <= 0 || ntiles < 0 || ntiles > tiles_x * tiles_y)
    fail("JPEG 2000 plan of a bad geometry");
  int prec[4];
  for (int c = 0; c < ncomp; ++c) {
    prec[c] = pr.next();
    if (prec[c] < 1 || prec[c] > 16) fail("JPEG 2000 precision %d", prec[c]);
  }
  for (int k = 0; k < 3; ++k)
    if (rgb[k] < 0 || rgb[k] >= ncomp) fail("JPEG 2000 output of component %d", rgb[k]);
  if (shift < 0 || shift > 16) fail("JPEG 2000 shift %d", shift);
  if (sycc && ncomp != 3) fail("JPEG 2000 sYCC of %d components", ncomp);
  const Output output{out, rgb, shift, sycc != 0};
  std::vector<bool> done(static_cast<size_t>(tiles_x) * tiles_y);
  // a tile the codestream lacks stays as OpenJPEG zero-fills it, converted
  uint8_t fill[3] = {0, 0, 0};
  if (sycc) yuv_to_rgb(fill);
  for (size_t i = 0; i < static_cast<size_t>(width) * height; ++i)
    std::memcpy(out + 3 * i, fill, 3);
  for (int t = 0; t < ntiles; ++t) {
    TileParams tp;
    tp.index = pr.next();
    tp.progression = pr.next();
    tp.layers = pr.next();
    tp.mct = pr.next();
    tp.csty = pr.next();
    const int nranges = pr.next();
    if (tp.index < 0 || tp.index >= tiles_x * tiles_y || tp.progression < 0 ||
        tp.progression > 4 || tp.layers < 1 || tp.layers > 65535 || nranges < 0 || nranges > 255)
      fail("JPEG 2000 plan of a bad tile");
    for (int i = 0; i < nranges; ++i) {
      const int64_t off = static_cast<uint32_t>(pr.next());
      const int64_t len = static_cast<uint32_t>(pr.next());
      tp.ranges.push_back({off, len});
    }
    tp.packed = pr.next() != 0;
    const int nheaders = pr.next();
    if (nheaders < 0 || nheaders > 65535) fail("JPEG 2000 plan of %d packed headers", nheaders);
    for (int i = 0; i < nheaders; ++i) {
      const int64_t off = static_cast<uint32_t>(pr.next());
      const int64_t len = static_cast<uint32_t>(pr.next());
      tp.headers.push_back({off, len});
    }
    const int npocs = pr.next();
    if (npocs < 0 || npocs > 255) fail("JPEG 2000 plan of %d progression changes", npocs);
    for (int i = 0; i < npocs; ++i) {
      Poc e;
      e.r0 = pr.next();
      e.c0 = pr.next();
      e.l1 = pr.next();
      e.r1 = pr.next();
      e.c1 = pr.next();
      e.prog = pr.next();
      if (e.r0 < 0 || e.c0 < 0 || e.l1 < 0 || e.r1 < 0 || e.c1 < 0 || e.prog < 0 || e.prog > 4)
        fail("JPEG 2000 progression change out of range");
      tp.pocs.push_back(e);
    }
    tp.comps.resize(ncomp);
    for (int c = 0; c < ncomp; ++c) {
      CompParams& cp = tp.comps[c];
      cp.numres = pr.next();
      cp.cblkw = pr.next();
      cp.cblkh = pr.next();
      cp.qmfbid = pr.next();
      cp.guard = pr.next();
      cp.style = pr.next();
      cp.roishift = pr.next();
      if (cp.numres < 1 || cp.numres > 33 || cp.cblkw < 2 || cp.cblkh < 2 ||
          cp.cblkw + cp.cblkh > 12 || cp.qmfbid < 0 || cp.qmfbid > 1 || cp.guard < 0 ||
          cp.guard > 7 || (cp.style & ~kDecodedStyles) || cp.roishift < 0 || cp.roishift > 255)
        fail("JPEG 2000 plan of bad coding parameters");
      for (int r = 0; r < cp.numres; ++r) {
        cp.ppx[r] = pr.next();
        cp.ppy[r] = pr.next();
        if (cp.ppx[r] < (r ? 1 : 0) || cp.ppx[r] > 15 || cp.ppy[r] < (r ? 1 : 0) || cp.ppy[r] > 15)
          fail("JPEG 2000 precinct exponent out of range");
      }
      for (int b = 0; b < 3 * cp.numres - 2; ++b) {
        cp.expn[b] = pr.next();
        cp.mant[b] = pr.next();
        if (cp.expn[b] < 0 || cp.expn[b] > 31 || cp.mant[b] < 0 || cp.mant[b] > 2047)
          fail("JPEG 2000 quantisation step out of range");
      }
    }
    if (tp.mct && ncomp >= 3 &&
        (tp.comps[0].qmfbid != tp.comps[1].qmfbid || tp.comps[0].qmfbid != tp.comps[2].qmfbid))
      fail("JPEG 2000 MCT over components of different transforms");
    if (done[tp.index]) fail("JPEG 2000 plan of tile %d twice", tp.index);
    done[tp.index] = true;
    decode_tile(cs, size, tp, prec, ncomp, width, height, tile_w, tile_h, tiles_x, output);
  }
}

}  // namespace

extern "C" int vd_j2k_decode(const uint8_t* codestream, unsigned long size, const int32_t* plan,
                             unsigned long plan_len, const int* rgb, int shift, int sycc,
                             uint8_t* out, char* err, int err_len) {
  try {
    decode(codestream, size, plan, plan_len, rgb, shift, sycc, out);
    return 0;
  } catch (const J2kError& e) {
    std::snprintf(err, err_len, "%s", e.msg);
  } catch (const std::bad_alloc&) {
    std::snprintf(err, err_len, "out of memory");
  }
  return -1;
}
