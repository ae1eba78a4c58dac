// COCOeval's greedy detection matching in C++; the port's own copy of
// heltondetection_tpu/native/cocoeval_core.cpp. DetEval (utils/cocoeval.py)
// keeps the bookkeeping; this runs the O(T·D·G) matching of one (image,
// category, area range) with the semantics of COCOeval.evaluateImg and of
// the numpy matcher in utils/cocoeval.py, which the tests hold it to.
//
// Host code: it includes only <cstdint>, so g++ builds it wherever it is
// (native/__init__.py, at first use, into the package's _build/).

#include <cstdint>

extern "C" {

// ious: D*G row-major; g_ig sorted non-ignored-first by the caller.
// dtm, dt_ig: T*D outputs.
void match_dets(int T, const double* iou_thrs,
                int D, int G,
                const double* ious,
                const int64_t* g_ig,
                const int64_t* g_crowd,
                int64_t* dtm,
                int64_t* dt_ig) {
  // the gt each gt is matched to, per threshold pass (G may be 0)
  int64_t* gtm = new int64_t[G > 0 ? G : 1];
  for (int t = 0; t < T; ++t) {
    double thr = iou_thrs[t];
    if (thr > 1.0 - 1e-10) thr = 1.0 - 1e-10;
    for (int g = 0; g < G; ++g) gtm[g] = -1;
    for (int d = 0; d < D; ++d) {
      double best = thr;
      int m = -1;
      const double* row = ious + (int64_t)d * G;
      for (int g = 0; g < G; ++g) {
        // a gt already matched (and not a crowd) is taken
        if (gtm[g] >= 0 && !g_crowd[g]) continue;
        // a non-ignored match is found and the ignored gts (sorted to the
        // back) begin: stop
        if (m > -1 && g_ig[m] == 0 && g_ig[g] == 1) break;
        if (row[g] < best) continue;
        best = row[g];   // >= updates: among ties the LAST gt wins
        m = g;
      }
      int64_t* dtm_t = dtm + (int64_t)t * D;
      int64_t* dtig_t = dt_ig + (int64_t)t * D;
      if (m == -1) {
        dtm_t[d] = -1;
        dtig_t[d] = 0;
      } else {
        dtm_t[d] = m;
        dtig_t[d] = g_ig[m];
        gtm[m] = d;
      }
    }
  }
  delete[] gtm;
}

}  // extern "C"
