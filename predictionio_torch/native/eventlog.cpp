// eventlog: append-only binary event log with in-memory index.
//
// The native data plane of the EVENTDATA storage tier — the role HBase
// plays in the reference (data/.../storage/hbase/HBEventsUtil.scala:47:
// rowkey = MD5(entity) || time || uuid, scans via partial row keys +
// column filters). Same design pressures, single-binary execution:
//   - append-only log per (app, channel), like an HBase region's WAL+store
//   - in-memory index of (time, entity-hash, name-hash) per record, so
//     filtered scans (PEvents.find semantics, storage/PEvents.scala:70)
//     touch only the index until materialization
//   - deletes are tombstones (HBase delete markers) carrying the log
//     offset at delete time, so they mask only earlier records — an id
//     re-inserted after a delete is live again
//   - single writer process: an flock(2) on <dir>/LOCK is held for the
//     handle's lifetime; a second process gets a clean open error
//     instead of silent corruption (concurrent access goes through the
//     event server REST API, as HBase clients go through the region
//     server)
//
// Record wire format (little-endian), produced by the Python binding:
//   u32  record_len            (bytes after this field)
//   u8   id[16]                (event id, raw uuid bytes)
//   i64  event_time_us         (epoch micros, UTC)
//   i64  creation_time_us
//   u16  len_event
//   u16  len_entity_type
//   u16  len_entity_id
//   u16  len_target_type       (0xFFFF = absent)
//   u16  len_target_id         (0xFFFF = absent)
//   u32  len_extra             (opaque JSON: properties/tags/prId/tz)
//   bytes: event, entity_type, entity_id, [target_type], [target_id], extra
//
// Tombstone file format: 24-byte entries, u8 id[16] + u64 cutoff_offset.
//
// Concurrency (in-process): one writer at a time (exclusive lock on
// append/delete), many readers (shared lock on find/get). The file is
// mmap'ed in 64 MiB-rounded chunks so most appends need no remap; only
// bytes below file_size are ever dereferenced.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread eventlog.cpp -o _eventlog.so

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <memory>
#include <mutex>
#include <random>
#include <shared_mutex>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/file.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include "binlayout.h"

namespace {

constexpr uint32_t kHeaderLen = 46;  // bytes after record_len, before strings
constexpr uint16_t kAbsent = 0xFFFF;
constexpr uint64_t kMapChunk = 64ULL << 20;  // mapping granularity
// index snapshot (see write_index_snapshot): rewritten on close and
// after every kSnapshotInterval of appended bytes, so reopening a 20M-
// event log costs one sequential array read + a short suffix replay
// instead of re-parsing the whole log (the open-cost complaint HBase
// answers with persistent region indexes)
constexpr uint64_t kSnapshotInterval = 1ULL << 30;
constexpr uint32_t kIndexMagic = 0x58494C45;  // "ELIX"
constexpr uint32_t kIndexVersion = 2;
// Compaction commit protocol: log+tombstones for generation N live in
// log.<N>.bin / tombstones.<N>.bin (generation 0 keeps the legacy
// names log.bin / tombstones.bin). The CURRENT file names the active
// generation; el_compact writes the next generation's files, then
// commits by atomically renaming CURRENT — so a crash at ANY point
// leaves a consistent (old or new) generation, never a compacted log
// paired with stale tombstone cutoffs that could mask relocated live
// records. Orphaned files from aborted compactions are removed on
// open (safe under the flock).

inline uint64_t fnv1a(const uint8_t* data, size_t n, uint64_t h = 1469598103934665603ULL) {
  for (size_t i = 0; i < n; ++i) {
    h ^= data[i];
    h *= 1099511628211ULL;
  }
  return h;
}

struct RecMeta {
  uint64_t offset;    // offset of the u32 record_len field
  uint32_t len;       // record_len
  int64_t time_us;
  int64_t ctime_us;
  uint64_t etype_hash;
  uint64_t eid_hash;
  uint64_t name_hash;
  uint64_t ttype_hash;  // 0 when absent
  uint64_t tid_hash;    // 0 when absent
  uint8_t has_target_type;
  uint8_t has_target_id;
};

struct Header {
  const uint8_t* id;
  int64_t time_us;
  int64_t ctime_us;
  uint16_t len_event, len_etype, len_eid, len_ttype, len_tid;
  uint32_t len_extra;
  const uint8_t *event, *etype, *eid, *ttype, *tid;
};

// parse one record payload (the bytes after record_len); returns false on corruption
bool parse(const uint8_t* p, uint32_t len, Header* h) {
  if (len < kHeaderLen) return false;
  h->id = p;
  memcpy(&h->time_us, p + 16, 8);
  memcpy(&h->ctime_us, p + 24, 8);
  memcpy(&h->len_event, p + 32, 2);
  memcpy(&h->len_etype, p + 34, 2);
  memcpy(&h->len_eid, p + 36, 2);
  memcpy(&h->len_ttype, p + 38, 2);
  memcpy(&h->len_tid, p + 40, 2);
  memcpy(&h->len_extra, p + 42, 4);
  uint64_t need = kHeaderLen;
  need += h->len_event + h->len_etype + h->len_eid;
  uint16_t ltt = (h->len_ttype == kAbsent) ? 0 : h->len_ttype;
  uint16_t lti = (h->len_tid == kAbsent) ? 0 : h->len_tid;
  need += ltt + lti + h->len_extra;
  if (need != len) return false;
  const uint8_t* s = p + kHeaderLen;
  h->event = s;
  s += h->len_event;
  h->etype = s;
  s += h->len_etype;
  h->eid = s;
  s += h->len_eid;
  h->ttype = (h->len_ttype == kAbsent) ? nullptr : s;
  s += ltt;
  h->tid = (h->len_tid == kAbsent) ? nullptr : s;
  return true;
}

struct Log {
  int fd = -1;
  int tomb_fd = -1;
  int lock_fd = -1;
  std::string dir;
  uint64_t generation = 0;        // compaction generation (see CURRENT)
  uint64_t file_size = 0;
  uint64_t snapshot_covered = 0;  // log bytes covered by index.bin
  uint8_t* map = nullptr;
  uint64_t map_size = 0;
  bool broken = false;  // mapping failed after a durable append; reads error
  std::vector<RecMeta> recs;
  std::unordered_map<std::string, uint64_t> by_id;  // raw 16-byte id -> rec index
  std::unordered_map<std::string, uint64_t> tombs;  // id -> max cutoff offset
  bool has_dupes = false;  // an id was ever re-inserted; scans must
                           // consult by_id for liveness when set
  bool needs_id_verify = false;  // records were replayed past an index
                                 // snapshot after an unclean shutdown:
                                 // their dupe status is unknown until
                                 // ensure_id_index runs once
  // records appended via el_append_columnar carry fresh random ids, so
  // they are indexed lazily: by_id covers recs[0, indexed_upto) and is
  // completed on demand by el_get/el_delete (ensure_id_index). A bulk
  // 20M-row ingest therefore skips ~20M hash-map node inserts.
  uint64_t indexed_upto = 0;
  bool fsync_on_append = false;
  mutable std::shared_mutex mu;

  // every record is live: no tombstones and no superseded ids, so
  // scans skip the per-record by_id lookup (the dominant cost of a
  // 20M-row scan — one random DRAM access per record otherwise).
  // Unindexed records are fresh-id columnar appends — never dupes.
  bool all_live() const {
    return tombs.empty() && !has_dupes && !needs_id_verify;
  }

  ~Log() {
    if (map) munmap(map, map_size);
    if (fd >= 0) close(fd);
    if (tomb_fd >= 0) close(tomb_fd);
    if (lock_fd >= 0) close(lock_fd);  // releases the flock
  }

  // (re)map so that [0, file_size) is addressable; rounds the mapping up
  // to kMapChunk so appends rarely remap. Call with exclusive lock held.
  bool ensure_mapped() {
    if (file_size <= map_size && map) return true;
    if (file_size == 0) return true;
    uint64_t want = ((file_size + kMapChunk - 1) / kMapChunk) * kMapChunk;
    if (map) {
      munmap(map, map_size);
      map = nullptr;
      map_size = 0;
    }
    void* m = mmap(nullptr, want, PROT_READ, MAP_SHARED, fd, 0);
    if (m == MAP_FAILED) return false;
    map = static_cast<uint8_t*>(m);
    map_size = want;
    return true;
  }

  bool dead(const std::string& id, uint64_t offset) const {
    auto it = tombs.find(id);
    return it != tombs.end() && it->second > offset;
  }

  void index_record(uint64_t offset, uint32_t len, const Header& h,
                    bool fresh_ids = false) {
    RecMeta m;
    m.offset = offset;
    m.len = len;
    m.time_us = h.time_us;
    m.ctime_us = h.ctime_us;
    m.etype_hash = fnv1a(h.etype, h.len_etype);
    m.eid_hash = fnv1a(h.eid, h.len_eid);
    m.name_hash = fnv1a(h.event, h.len_event);
    m.has_target_type = h.ttype != nullptr;
    m.has_target_id = h.tid != nullptr;
    m.ttype_hash = h.ttype ? fnv1a(h.ttype, h.len_ttype) : 0;
    m.tid_hash = h.tid ? fnv1a(h.tid, h.len_tid) : 0;
    if (fresh_ids) {
      // fresh random ids can't collide: defer by_id (ensure_id_index).
      // Invariant: by_id covers exactly [0, indexed_upto) — non-fresh
      // appends pay any debt first (append_packed), so the debt region
      // is always a fresh-ids suffix and eager inserts below always
      // run with indexed_upto == recs.size().
      recs.push_back(m);
      return;
    }
    ++indexed_upto;
    std::string id(reinterpret_cast<const char*>(h.id), 16);
    if (!dead(id, offset)) {
      auto [it, inserted] = by_id.try_emplace(std::move(id), recs.size());
      if (!inserted) {
        it->second = recs.size();
        has_dupes = true;
      }
    }
    recs.push_back(m);
  }

  // complete by_id over [indexed_upto, recs.size()) — called (with the
  // exclusive lock) before any id-keyed operation
  void ensure_id_index() {
    if (indexed_upto == recs.size()) return;
    by_id.reserve(by_id.size() + (recs.size() - indexed_upto));
    for (uint64_t i = indexed_upto; i < recs.size(); ++i) {
      Header h;
      parse(map + recs[i].offset + 4, recs[i].len, &h);
      std::string id(reinterpret_cast<const char*>(h.id), 16);
      if (!dead(id, recs[i].offset)) {
        auto [it, inserted] = by_id.try_emplace(std::move(id), i);
        if (!inserted) {
          it->second = i;
          has_dupes = true;
        }
      }
    }
    indexed_upto = recs.size();
    needs_id_verify = false;  // dupe status now exact
  }
};

struct FindReq {
  int64_t start_us;   // INT64_MIN = unbounded
  int64_t until_us;   // INT64_MAX = unbounded
  const char* entity_type;  // nullptr = no filter
  const char* entity_id;
  int32_t target_type_mode;  // 0 = no filter, 1 = must be absent, 2 = equals
  int32_t target_id_mode;
  const char* target_entity_type;
  const char* target_entity_id;
  const char* event_names;  // '\0'-joined
  int32_t n_event_names;    // 0 = no filter
  int32_t reversed;
  int64_t limit;  // -1 = all
};

bool bytes_eq(const uint8_t* a, uint32_t alen, const char* b) {
  return alen == strlen(b) && memcmp(a, b, alen) == 0;
}

// precomputed filter hashes for one FindReq
struct FilterCtx {
  uint64_t etype_h = 0, eid_h = 0, ttype_h = 0, tid_h = 0;
  std::vector<std::pair<uint64_t, const char*>> name_hashes;
};

FilterCtx make_filter_ctx(const FindReq* req) {
  FilterCtx c;
  if (req->entity_type)
    c.etype_h = fnv1a(reinterpret_cast<const uint8_t*>(req->entity_type),
                      strlen(req->entity_type));
  if (req->entity_id)
    c.eid_h = fnv1a(reinterpret_cast<const uint8_t*>(req->entity_id),
                    strlen(req->entity_id));
  if (req->target_type_mode == 2)
    c.ttype_h = fnv1a(reinterpret_cast<const uint8_t*>(req->target_entity_type),
                      strlen(req->target_entity_type));
  if (req->target_id_mode == 2)
    c.tid_h = fnv1a(reinterpret_cast<const uint8_t*>(req->target_entity_id),
                    strlen(req->target_entity_id));
  const char* p = req->event_names;
  for (int32_t i = 0; i < req->n_event_names; ++i) {
    size_t l = strlen(p);
    c.name_hashes.emplace_back(fnv1a(reinterpret_cast<const uint8_t*>(p), l), p);
    p += l + 1;
  }
  return c;
}

// One record's filter check: index-hash prefilter, then header parse,
// liveness (current by_id entry) and byte-wise string confirmation
// (hash-collision guard). Fills *hd on a true return so callers parse
// only once. Caller must hold a shared lock.
bool match_rec(const Log* log, const FindReq* req, const FilterCtx& c,
               uint64_t i, Header* hd) {
  const RecMeta& m = log->recs[i];
  if (m.time_us < req->start_us || m.time_us >= req->until_us) return false;
  if (req->entity_type && m.etype_hash != c.etype_h) return false;
  if (req->entity_id && m.eid_hash != c.eid_h) return false;
  if (req->target_type_mode == 1 && m.has_target_type) return false;
  if (req->target_type_mode == 2 && (!m.has_target_type || m.ttype_hash != c.ttype_h)) return false;
  if (req->target_id_mode == 1 && m.has_target_id) return false;
  if (req->target_id_mode == 2 && (!m.has_target_id || m.tid_hash != c.tid_h)) return false;
  if (req->n_event_names > 0) {
    bool any = false;
    for (const auto& nh : c.name_hashes) {
      if (nh.first == m.name_hash) { any = true; break; }
    }
    if (!any) return false;
  }
  parse(log->map + m.offset + 4, m.len, hd);
  if (!log->all_live()) {
    auto live = log->by_id.find(std::string(reinterpret_cast<const char*>(hd->id), 16));
    if (live == log->by_id.end() || live->second != i) return false;
  }
  if (req->entity_type && !bytes_eq(hd->etype, hd->len_etype, req->entity_type)) return false;
  if (req->entity_id && !bytes_eq(hd->eid, hd->len_eid, req->entity_id)) return false;
  if (req->target_type_mode == 2 &&
      !bytes_eq(hd->ttype, hd->len_ttype, req->target_entity_type)) return false;
  if (req->target_id_mode == 2 &&
      !bytes_eq(hd->tid, hd->len_tid, req->target_entity_id)) return false;
  if (req->n_event_names > 0) {
    bool any = false;
    for (const auto& nh : c.name_hashes) {
      if (bytes_eq(hd->event, hd->len_event, nh.second)) { any = true; break; }
    }
    if (!any) return false;
  }
  return true;
}

// Filtered index scan shared by el_find / sorted columnar finds: fills
// `hits` with live matching record indices, sorted by (time, ctime,
// arrival). Caller must hold a shared lock.
void collect_hits(const Log* log, const FindReq* req, std::vector<uint64_t>* hits) {
  FilterCtx ctx = make_filter_ctx(req);
  Header hd;
  for (uint64_t i = 0; i < log->recs.size(); ++i) {
    if (match_rec(log, req, ctx, i, &hd)) hits->push_back(i);
  }

  auto key_less = [log](uint64_t a, uint64_t b) {
    const RecMeta& ma = log->recs[a];
    const RecMeta& mb = log->recs[b];
    if (ma.time_us != mb.time_us) return ma.time_us < mb.time_us;
    if (ma.ctime_us != mb.ctime_us) return ma.ctime_us < mb.ctime_us;
    return a < b;
  };
  if (req->reversed)
    std::sort(hits->begin(), hits->end(), [&](uint64_t a, uint64_t b) { return key_less(b, a); });
  else
    std::sort(hits->begin(), hits->end(), key_less);
  if (req->limit >= 0 && hits->size() > static_cast<uint64_t>(req->limit))
    hits->resize(req->limit);
}

// ---------------------------------------------------------------------------
// minimal JSON walking over the record's `extra` blob (written by our own
// packer: compact json.dumps output) to pull one numeric property out of
// the "p" object without materializing Python events
// ---------------------------------------------------------------------------

// advance past one JSON value starting at s (s < e); returns nullptr on
// malformed input
const char* skip_json_value(const char* s, const char* e);

const char* skip_ws(const char* s, const char* e) {
  while (s < e && (*s == ' ' || *s == '\t' || *s == '\n' || *s == '\r')) ++s;
  return s;
}

const char* skip_json_string(const char* s, const char* e) {  // s at opening quote
  ++s;
  while (s < e) {
    if (*s == '\\') { s += 2; continue; }
    if (*s == '"') return s + 1;
    ++s;
  }
  return nullptr;
}

const char* skip_json_container(const char* s, const char* e, char open, char close) {
  int depth = 0;
  while (s < e) {
    if (*s == '"') {
      s = skip_json_string(s, e);
      if (!s) return nullptr;
      continue;
    }
    if (*s == open) ++depth;
    else if (*s == close) {
      if (--depth == 0) return s + 1;
    }
    ++s;
  }
  return nullptr;
}

const char* skip_json_value(const char* s, const char* e) {
  s = skip_ws(s, e);
  if (s >= e) return nullptr;
  if (*s == '"') return skip_json_string(s, e);
  if (*s == '{') return skip_json_container(s, e, '{', '}');
  if (*s == '[') return skip_json_container(s, e, '[', ']');
  while (s < e && *s != ',' && *s != '}' && *s != ']') ++s;  // number/true/false/null
  return s;
}

// extract extra["p"][key] as a double; NaN when absent or non-numeric
double extract_prop(const uint8_t* extra, uint32_t len, const char* key) {
  const double nan = std::numeric_limits<double>::quiet_NaN();
  const char* s = reinterpret_cast<const char*>(extra);
  const char* e = s + len;
  // fast path: records written by el_append_columnar (and any compact
  // extra whose first property is the key) start {"p":{"<key>":
  {
    size_t klen = strlen(key);
    if (len > 8 + klen && memcmp(s, "{\"p\":{\"", 7) == 0 &&
        memcmp(s + 7, key, klen) == 0 && s[7 + klen] == '"' &&
        s[8 + klen] == ':') {
      const char* v = s + 9 + klen;
      if (v < e && (*v == '-' || (*v >= '0' && *v <= '9'))) {
        char numbuf[64];
        size_t n = std::min<size_t>(e - v, 63);
        memcpy(numbuf, v, n);
        numbuf[n] = 0;
        return strtod(numbuf, nullptr);
      }
    }
  }
  s = skip_ws(s, e);
  if (s >= e || *s != '{') return nan;
  ++s;
  size_t klen = strlen(key);
  // walk the top-level object to find "p"
  while (true) {
    s = skip_ws(s, e);
    if (s >= e || *s == '}') return nan;
    if (*s == ',') { ++s; continue; }
    if (*s != '"') return nan;
    const char* kstart = s + 1;
    const char* kend_q = skip_json_string(s, e);
    if (!kend_q) return nan;
    const char* kend = kend_q - 1;
    s = skip_ws(kend_q, e);
    if (s >= e || *s != ':') return nan;
    ++s;
    s = skip_ws(s, e);
    bool is_p = (kend - kstart) == 1 && *kstart == 'p';
    if (!is_p) {
      s = skip_json_value(s, e);
      if (!s) return nan;
      continue;
    }
    // inside "p": walk its pairs for `key`
    if (s >= e || *s != '{') return nan;
    ++s;
    while (true) {
      s = skip_ws(s, e);
      if (s >= e || *s == '}') return nan;
      if (*s == ',') { ++s; continue; }
      if (*s != '"') return nan;
      const char* pstart = s + 1;
      const char* pend_q = skip_json_string(s, e);
      if (!pend_q) return nan;
      const char* pend = pend_q - 1;
      s = skip_ws(pend_q, e);
      if (s >= e || *s != ':') return nan;
      ++s;
      s = skip_ws(s, e);
      if (static_cast<size_t>(pend - pstart) == klen &&
          memcmp(pstart, key, klen) == 0) {
        if (s < e && (*s == '-' || (*s >= '0' && *s <= '9'))) {
          char numbuf[64];
          size_t n = std::min<size_t>(e - s, 63);
          memcpy(numbuf, s, n);
          numbuf[n] = 0;
          return strtod(numbuf, nullptr);
        }
        return nan;  // present but not numeric
      }
      s = skip_json_value(s, e);
      if (!s) return nan;
    }
  }
}

// the value_property of one parsed record (NaN when absent/non-numeric)
double header_value(const Header& hd, const char* value_prop) {
  if (!hd.len_extra) return std::numeric_limits<double>::quiet_NaN();
  const uint8_t* extra = hd.tid   ? hd.tid + hd.len_tid
                       : hd.ttype ? hd.ttype + hd.len_ttype
                                  : hd.eid + hd.len_eid;
  return extract_prop(extra, hd.len_extra, value_prop);
}

// worker count for the parallel fused columnar scan: opt-out/override
// via PIO_EVENTLOG_SCAN_THREADS; single-threaded below 2M records
// (thread spin-up + merge overhead beats the win on small scans)
unsigned scan_thread_count(uint64_t nrec) {
  const char* env = getenv("PIO_EVENTLOG_SCAN_THREADS");
  if (env && *env) {
    long v = strtol(env, nullptr, 10);
    // <=0 (incl. "0", the natural opt-out spelling, and garbage) means
    // single-threaded — never "ignore the override and auto-scale"
    if (v < 1) return 1;
    return static_cast<unsigned>(std::min<long>(v, 64));
  }
  if (nrec < 2000000) return 1;
  unsigned hw = std::thread::hardware_concurrency();
  return hw ? std::min(hw, 8u) : 1;
}

// dict encoder for string columns: string -> code in first-seen order,
// dictionary emitted as concatenated bytes + exact prefix offsets (ids
// may legally contain ANY byte, including NUL, so a separator-joined
// format would be ambiguous). Keys are string_views into the mmap'ed
// log (stable under the shared lock held for the whole scan), so
// encoding 20M rows allocates nothing per row.
struct DictEncoder {
  std::unordered_map<std::string_view, int32_t> codes;
  std::vector<std::string_view> order;

  int32_t encode(const uint8_t* s, uint32_t len) {
    std::string_view key(reinterpret_cast<const char*>(s), len);
    auto it = codes.find(key);
    if (it != codes.end()) return it->second;
    int32_t code = static_cast<int32_t>(order.size());
    codes.emplace(key, code);
    order.push_back(key);
    return code;
  }

  // concatenated dictionary bytes + (order.size()+1) prefix offsets;
  // caller owns both (el_free)
  uint8_t* dump(uint64_t* nbytes, uint64_t** offsets_out) const {
    uint64_t total = 0;
    for (const auto& s : order) total += s.size();
    uint8_t* buf = static_cast<uint8_t*>(malloc(total ? total : 1));
    if (!buf) return nullptr;
    uint64_t* offs =
        static_cast<uint64_t*>(malloc(sizeof(uint64_t) * (order.size() + 1)));
    if (!offs) {
      free(buf);
      return nullptr;
    }
    uint64_t w = 0;
    size_t i = 0;
    for (const auto& s : order) {
      offs[i++] = w;
      memcpy(buf + w, s.data(), s.size());
      w += s.size();
    }
    offs[i] = w;
    *nbytes = total;
    *offsets_out = offs;
    return buf;
  }
};

// Copy accumulated column vectors + dictionaries into malloc'd outputs
// (the shared tail of el_find_columnar / el_find_columnar_since). On
// allocation failure everything allocated so far is freed and -1 comes
// back; otherwise the row count.
int64_t finish_columns(
    const DictEncoder& ents, const DictEncoder& tgts, const DictEncoder& names,
    const std::vector<int32_t>& ent_v, const std::vector<int32_t>& tgt_v,
    const std::vector<int32_t>& name_v, const std::vector<double>& val_v,
    const std::vector<int64_t>& time_v,
    int32_t** ent_codes_out, int32_t** tgt_codes_out,
    int32_t** name_codes_out, double** values_out, int64_t** times_us_out,
    uint8_t** ent_dict_out, uint64_t* ent_dict_bytes, int64_t* n_ent,
    uint8_t** tgt_dict_out, uint64_t* tgt_dict_bytes, int64_t* n_tgt,
    uint8_t** name_dict_out, uint64_t* name_dict_bytes, int64_t* n_names,
    uint64_t** ent_offsets_out, uint64_t** tgt_offsets_out,
    uint64_t** name_offsets_out) {
  auto copy_out = [](const auto& v, auto** out) {
    using T = typename std::remove_reference_t<decltype(v)>::value_type;
    T* buf = static_cast<T*>(malloc(sizeof(T) * (v.size() ? v.size() : 1)));
    if (!buf) return false;
    memcpy(buf, v.data(), sizeof(T) * v.size());
    *out = buf;
    return true;
  };
  int32_t* ent_codes = nullptr;
  int32_t* tgt_codes = nullptr;
  int32_t* name_codes = nullptr;
  double* values = nullptr;
  int64_t* times_us = nullptr;
  if (!copy_out(ent_v, &ent_codes) || !copy_out(tgt_v, &tgt_codes) ||
      !copy_out(name_v, &name_codes) || !copy_out(val_v, &values) ||
      !copy_out(time_v, &times_us)) {
    free(ent_codes); free(tgt_codes); free(name_codes); free(values); free(times_us);
    return -1;
  }

  uint64_t* ent_offs = nullptr;
  uint64_t* tgt_offs = nullptr;
  uint64_t* name_offs = nullptr;
  uint8_t* ent_dict = ents.dump(ent_dict_bytes, &ent_offs);
  uint8_t* tgt_dict = tgts.dump(tgt_dict_bytes, &tgt_offs);
  uint8_t* name_dict = names.dump(name_dict_bytes, &name_offs);
  if (!ent_dict || !tgt_dict || !name_dict) {
    free(ent_codes); free(tgt_codes); free(name_codes); free(values); free(times_us);
    free(ent_dict); free(tgt_dict); free(name_dict);
    free(ent_offs); free(tgt_offs); free(name_offs);
    return -1;
  }
  *ent_codes_out = ent_codes;
  *tgt_codes_out = tgt_codes;
  *name_codes_out = name_codes;
  *values_out = values;
  *times_us_out = times_us;
  *ent_dict_out = ent_dict;
  *tgt_dict_out = tgt_dict;
  *name_dict_out = name_dict;
  *ent_offsets_out = ent_offs;
  *tgt_offsets_out = tgt_offs;
  *name_offsets_out = name_offs;
  *n_ent = static_cast<int64_t>(ents.order.size());
  *n_tgt = static_cast<int64_t>(tgts.order.size());
  *n_names = static_cast<int64_t>(names.order.size());
  return static_cast<int64_t>(ent_v.size());
}

// Fused filter + dict-encode scan in LOG order (no sort, each record
// parsed exactly once), single- or multi-threaded — the shared body of
// el_find_columnar's bulk fast path and el_bin_columnar. Caller must
// hold a shared lock. ``want_times`` skips the per-row time vector
// (the binning lane never reads it; at 20M rows that is 160 MB of
// writes saved).
void fused_scan(const Log* log, const FindReq* req, const char* value_prop,
                bool want_times,
                DictEncoder* ents, DictEncoder* tgts, DictEncoder* names,
                std::vector<int32_t>* ent_v, std::vector<int32_t>* tgt_v,
                std::vector<int32_t>* name_v, std::vector<double>* val_v,
                std::vector<int64_t>* time_v) {
  const double nan = std::numeric_limits<double>::quiet_NaN();
  FilterCtx ctx = make_filter_ctx(req);
  const uint64_t nrec = log->recs.size();
  const unsigned nt = scan_thread_count(nrec);
  if (nt <= 1) {
    Header hd;
    for (uint64_t i = 0; i < nrec; ++i) {
      if (!match_rec(log, req, ctx, i, &hd)) continue;
      ent_v->push_back(ents->encode(hd.eid, hd.len_eid));
      tgt_v->push_back(hd.tid ? tgts->encode(hd.tid, hd.len_tid) : -1);
      name_v->push_back(names->encode(hd.event, hd.len_event));
      if (want_times) time_v->push_back(hd.time_us);
      val_v->push_back(value_prop ? header_value(hd, value_prop) : nan);
    }
    return;
  }
  // parallel fused scan: workers filter+encode contiguous record
  // ranges with LOCAL dictionaries (mmap/recs/by_id are read-only
  // under the shared lock), then ranges merge in order. Every
  // range-r global-first-seen id precedes every range-(r+1) one,
  // and within a range local first-seen order IS record order, so
  // the merged code assignment is byte-identical to the
  // sequential scan's.
  struct ColPart {
    DictEncoder ents, tgts, names;
    std::vector<int32_t> ent, tgt, name;
    std::vector<double> val;
    std::vector<int64_t> time;
  };
  std::vector<ColPart> parts(nt);
  std::vector<std::thread> workers;
  workers.reserve(nt);
  for (unsigned t = 0; t < nt; ++t) {
    const uint64_t lo = nrec * t / nt, hi = nrec * (t + 1) / nt;
    workers.emplace_back([&, t, lo, hi]() {
      ColPart& p = parts[t];
      Header hd;
      for (uint64_t i = lo; i < hi; ++i) {
        if (!match_rec(log, req, ctx, i, &hd)) continue;
        p.ent.push_back(p.ents.encode(hd.eid, hd.len_eid));
        p.tgt.push_back(hd.tid ? p.tgts.encode(hd.tid, hd.len_tid) : -1);
        p.name.push_back(p.names.encode(hd.event, hd.len_event));
        if (want_times) p.time.push_back(hd.time_us);
        p.val.push_back(value_prop ? header_value(hd, value_prop) : nan);
      }
    });
  }
  for (auto& w : workers) w.join();
  uint64_t total = 0;
  for (const auto& p : parts) total += p.ent.size();
  ent_v->reserve(total);
  tgt_v->reserve(total);
  name_v->reserve(total);
  val_v->reserve(total);
  if (want_times) time_v->reserve(total);
  auto remap = [](DictEncoder& global, const DictEncoder& local) {
    std::vector<int32_t> table(local.order.size());
    for (size_t i = 0; i < local.order.size(); ++i) {
      const std::string_view& sv = local.order[i];
      table[i] = global.encode(
          reinterpret_cast<const uint8_t*>(sv.data()),
          static_cast<uint32_t>(sv.size()));
    }
    return table;
  };
  for (const auto& p : parts) {
    const std::vector<int32_t> ent_map = remap(*ents, p.ents);
    const std::vector<int32_t> tgt_map = remap(*tgts, p.tgts);
    const std::vector<int32_t> name_map = remap(*names, p.names);
    for (size_t i = 0; i < p.ent.size(); ++i) {
      ent_v->push_back(ent_map[p.ent[i]]);
      tgt_v->push_back(p.tgt[i] >= 0 ? tgt_map[p.tgt[i]] : -1);
      name_v->push_back(name_map[p.name[i]]);
    }
    val_v->insert(val_v->end(), p.val.begin(), p.val.end());
    if (want_times)
      time_v->insert(time_v->end(), p.time.begin(), p.time.end());
  }
}

// ---------------------------------------------------------------------------
// persisted index snapshot: header + the raw RecMeta array. A local
// cache file (same-machine, same-build reader — sizeof(RecMeta) is
// checked), written atomically via tmp+rename. by_id is NOT persisted:
// it is rebuilt lazily (ensure_id_index) only when an id-keyed
// operation or a non-all-live scan needs it; the all-live fast path —
// bulk training reads — never does.
// ---------------------------------------------------------------------------

struct IndexHeader {
  uint32_t magic;
  uint32_t version;
  uint32_t recmeta_size;
  uint8_t has_dupes;
  uint8_t pad[3];
  uint64_t generation;
  uint64_t covered_bytes;
  uint64_t n_recs;
  uint64_t checksum;  // fnv1a over the RecMeta array bytes
};

bool write_all(int fd, const void* data, uint64_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(data);
  uint64_t w = 0;
  while (w < n) {
    ssize_t r = write(fd, p + w, n - w);
    if (r < 0) return false;
    w += static_cast<uint64_t>(r);
  }
  return true;
}

// make directory-entry operations (create/rename/unlink) durable —
// without this, a power failure can persist them in ANY order and
// break the compaction commit protocol's ordering assumptions
bool fsync_dir(const std::string& dir) {
  int dfd = open(dir.c_str(), O_RDONLY | O_DIRECTORY);
  if (dfd < 0) return false;
  bool ok = fsync(dfd) == 0;
  close(dfd);
  return ok;
}

std::string log_path_for(const std::string& dir, uint64_t gen) {
  return gen == 0 ? dir + "/log.bin"
                  : dir + "/log." + std::to_string(gen) + ".bin";
}

std::string tomb_path_for(const std::string& dir, uint64_t gen) {
  return gen == 0 ? dir + "/tombstones.bin"
                  : dir + "/tombstones." + std::to_string(gen) + ".bin";
}

// active generation: contents of <dir>/CURRENT (absent -> 0)
uint64_t read_generation(const std::string& dir) {
  FILE* f = fopen((dir + "/CURRENT").c_str(), "r");
  if (!f) return 0;
  unsigned long long gen = 0;
  int n = fscanf(f, "%llu", &gen);
  fclose(f);
  return n == 1 ? static_cast<uint64_t>(gen) : 0;
}

// atomically commit a new generation; returns false (leaving the old
// generation active) on any failure
bool commit_generation(const std::string& dir, uint64_t gen) {
  std::string tmp = dir + "/CURRENT.tmp";
  int fd = open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return false;
  std::string body = std::to_string(gen) + "\n";
  bool ok = write_all(fd, body.data(), body.size()) && fdatasync(fd) == 0;
  close(fd);
  if (!ok || rename(tmp.c_str(), (dir + "/CURRENT").c_str()) != 0) {
    unlink(tmp.c_str());
    return false;
  }
  return true;
}

// remove log/tombstone files of other generations (aborted compactions
// or superseded generations); caller holds the flock
void remove_orphan_generations(const std::string& dir, uint64_t keep_gen) {
  for (uint64_t g = 0; g <= keep_gen + 1; ++g) {
    if (g == keep_gen) continue;
    unlink(log_path_for(dir, g).c_str());
    unlink(tomb_path_for(dir, g).c_str());
  }
}

// caller holds the exclusive lock
bool write_index_snapshot(Log* log) {
  // the header's has_dupes must be exact — resolve any post-crash
  // lazily-replayed region before persisting it
  if (log->needs_id_verify) log->ensure_id_index();
  std::string tmp = log->dir + "/index.bin.tmp";
  std::string final_path = log->dir + "/index.bin";
  int fd = open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return false;
  IndexHeader hdr{};
  hdr.magic = kIndexMagic;
  hdr.version = kIndexVersion;
  hdr.recmeta_size = sizeof(RecMeta);
  hdr.has_dupes = log->has_dupes ? 1 : 0;
  hdr.generation = log->generation;
  hdr.covered_bytes = log->file_size;
  hdr.n_recs = log->recs.size();
  hdr.checksum = fnv1a(reinterpret_cast<const uint8_t*>(log->recs.data()),
                       sizeof(RecMeta) * log->recs.size());
  bool ok = write_all(fd, &hdr, sizeof(hdr)) &&
            write_all(fd, log->recs.data(), sizeof(RecMeta) * log->recs.size());
  if (ok) ok = fdatasync(fd) == 0;
  close(fd);
  if (!ok || rename(tmp.c_str(), final_path.c_str()) != 0) {
    unlink(tmp.c_str());
    return false;
  }
  log->snapshot_covered = log->file_size;
  return true;
}

// loads recs/has_dupes from index.bin when it matches this log; returns
// the number of log bytes covered (0 = no usable snapshot, replay all).
// A corrupt/stale cache file must DEGRADE (full replay), never crash or
// poison the index: the header is bounds-checked against the index
// file's own size before any allocation, the array is checksummed, and
// the record chain is verified contiguous over [0, covered_bytes).
uint64_t load_index_snapshot(Log* log) {
  std::string path = log->dir + "/index.bin";
  int fd = open(path.c_str(), O_RDONLY);
  if (fd < 0) return 0;
  struct stat ist;
  IndexHeader hdr{};
  // n_recs is validated by DIVISION against the index file's own size
  // (a multiply could wrap uint64 and let a corrupt header through to
  // the resize below)
  bool ok = fstat(fd, &ist) == 0 &&
            read(fd, &hdr, sizeof(hdr)) == static_cast<ssize_t>(sizeof(hdr)) &&
            hdr.magic == kIndexMagic && hdr.version == kIndexVersion &&
            hdr.recmeta_size == sizeof(RecMeta) &&
            hdr.generation == log->generation &&
            hdr.covered_bytes <= log->file_size &&
            static_cast<uint64_t>(ist.st_size) >= sizeof(IndexHeader) &&
            (static_cast<uint64_t>(ist.st_size) - sizeof(IndexHeader)) %
                    sizeof(RecMeta) == 0 &&
            (static_cast<uint64_t>(ist.st_size) - sizeof(IndexHeader)) /
                    sizeof(RecMeta) == hdr.n_recs;
  if (ok) {
    log->recs.resize(hdr.n_recs);
    uint64_t want = sizeof(RecMeta) * hdr.n_recs;
    uint64_t got = 0;
    while (got < want) {
      ssize_t r = read(fd, reinterpret_cast<uint8_t*>(log->recs.data()) + got,
                       want - got);
      if (r <= 0) break;
      got += static_cast<uint64_t>(r);
    }
    ok = got == want &&
         fnv1a(reinterpret_cast<const uint8_t*>(log->recs.data()), want) ==
             hdr.checksum;
    // the snapshot must describe THIS log's exact record chain:
    // contiguous from offset 0 to covered_bytes, in-bounds lengths
    if (ok) {
      uint64_t expect = 0;
      for (const RecMeta& m : log->recs) {
        if (m.offset != expect || m.len < kHeaderLen ||
            m.offset + 4 + m.len > hdr.covered_bytes) {
          ok = false;
          break;
        }
        expect = m.offset + 4 + m.len;
      }
      if (ok && expect != hdr.covered_bytes) ok = false;
    }
    // spot-parse the last record as a final cross-check against the log
    if (ok && !log->recs.empty()) {
      Header h;
      const RecMeta& last = log->recs.back();
      ok = parse(log->map + last.offset + 4, last.len, &h);
    }
  }
  close(fd);
  if (!ok) {
    log->recs.clear();
    return 0;
  }
  log->has_dupes = hdr.has_dupes != 0;
  log->indexed_upto = 0;  // by_id rebuilt lazily when actually needed
  log->snapshot_covered = hdr.covered_bytes;
  return hdr.covered_bytes;
}

}  // namespace

extern "C" {

void el_free(uint8_t* p) { free(p); }

void* el_open(const char* dir, int fsync_on_append) {
  std::string base(dir);
  if (mkdir(base.c_str(), 0755) != 0 && errno != EEXIST) return nullptr;
  auto log = std::make_unique<Log>();
  log->dir = base;
  log->fsync_on_append = fsync_on_append != 0;

  // single-writer-process guard: held until el_close
  std::string lock_path = base + "/LOCK";
  log->lock_fd = open(lock_path.c_str(), O_RDWR | O_CREAT, 0644);
  if (log->lock_fd < 0) return nullptr;
  if (flock(log->lock_fd, LOCK_EX | LOCK_NB) != 0) return nullptr;

  log->generation = read_generation(base);
  remove_orphan_generations(base, log->generation);
  std::string log_path = log_path_for(base, log->generation);
  log->fd = open(log_path.c_str(), O_RDWR | O_CREAT | O_APPEND, 0644);
  if (log->fd < 0) return nullptr;
  std::string tomb_path = tomb_path_for(base, log->generation);
  log->tomb_fd = open(tomb_path.c_str(), O_RDWR | O_CREAT | O_APPEND, 0644);
  if (log->tomb_fd < 0) return nullptr;

  // load tombstones first: cutoffs decide liveness during log replay
  struct stat st;
  if (fstat(log->tomb_fd, &st) != 0) return nullptr;
  for (off_t off = 0; off + 24 <= st.st_size; off += 24) {
    uint8_t entry[24];
    if (pread(log->tomb_fd, entry, 24, off) != 24) return nullptr;
    std::string id(reinterpret_cast<const char*>(entry), 16);
    uint64_t cutoff;
    memcpy(&cutoff, entry + 16, 8);
    uint64_t& slot = log->tombs[id];
    if (cutoff > slot) slot = cutoff;
  }

  if (fstat(log->fd, &st) != 0) return nullptr;
  log->file_size = static_cast<uint64_t>(st.st_size);
  if (!log->ensure_mapped()) return nullptr;

  // fast open: load the persisted index snapshot (clean shutdowns
  // cover the whole log), then replay only the uncovered suffix; a
  // torn tail (crash mid-append) is truncated away, mirroring WAL
  // replay semantics. Suffix records are indexed lazily — their dupe
  // status is resolved by ensure_id_index on first need.
  uint64_t off = load_index_snapshot(log.get());
  uint64_t n_suffix = 0;
  while (off + 4 <= log->file_size) {
    uint32_t len;
    memcpy(&len, log->map + off, 4);
    if (off + 4 + len > log->file_size) break;  // torn tail
    Header h;
    if (!parse(log->map + off + 4, len, &h)) break;
    if (log->snapshot_covered > 0) {
      log->index_record(off, len, h, /*fresh_ids=*/true);
      ++n_suffix;
    } else {
      log->index_record(off, len, h);
    }
    off += 4 + len;
  }
  if (n_suffix > 0) log->needs_id_verify = true;
  if (off < log->file_size) {
    if (ftruncate(log->fd, off) != 0) return nullptr;
    log->file_size = off;
  }
  return log.release();
}

void el_close(void* h) {
  Log* log = static_cast<Log*>(h);
  if (!log->broken && log->file_size != log->snapshot_covered)
    write_index_snapshot(log);
  delete log;
}

namespace {

// scans that must consult by_id for liveness (tombstones/dupes exist)
// need the id index completed first; take the exclusive lock only when
// there is lazy-indexing debt to pay
void ensure_index_for_scan(Log* log) {
  bool need;
  {
    std::shared_lock lk(log->mu);
    need = !log->all_live() && log->indexed_upto != log->recs.size();
  }
  if (need) {
    std::unique_lock lk(log->mu);
    if (!log->broken) log->ensure_id_index();
  }
}

}  // namespace

namespace {

// write + index a batch of records already known to be well-formed
// (validated by el_append_json / el_append_rows, or built by
// el_append_columnar —
// fresh_ids = the batch's ids were freshly generated, enabling lazy
// id indexing)
int64_t append_packed(Log* log, const uint8_t* buf, uint64_t nbytes, int64_t n,
                      bool fresh_ids = false) {
  std::unique_lock lk(log->mu);
  if (log->broken) return -1;
  uint64_t written = 0;
  while (written < nbytes) {
    ssize_t w = write(log->fd, buf + written, nbytes - written);
    if (w < 0) {
      // partial batch on disk: re-truncate to the pre-batch size
      if (ftruncate(log->fd, log->file_size) != 0) {}
      return -1;
    }
    written += static_cast<uint64_t>(w);
  }
  if (log->fsync_on_append) fdatasync(log->fd);

  uint64_t base = log->file_size;
  log->file_size += nbytes;
  // index from the caller's buffer so indexing does not depend on the
  // remap succeeding; reserve up front so a 20M-row ingest doesn't
  // rehash the id map dozens of times. Caller-supplied ids could
  // duplicate an unindexed record, so pay any lazy-indexing debt first
  // (dup detection must see every id).
  // geometric growth floor: reserve(size + n) alone reallocates to
  // EXACTLY that size, so every subsequent append batch would copy the
  // whole 20M-entry index again (~1.6 GB per 100k-row batch on a
  // ML-20M log — measured as a steady-state row-lane collapse)
  if (log->recs.capacity() < log->recs.size() + n)
    log->recs.reserve(std::max(log->recs.size() + n,
                               log->recs.capacity() * 2));
  if (!fresh_ids) {
    log->ensure_id_index();
    // same doubling floor for the hash map: an exact-size reserve
    // rehashes ~all nodes on EVERY batch of a repeated ingest
    size_t want = log->by_id.size() + n;
    if (log->by_id.bucket_count() * log->by_id.max_load_factor() < want)
      log->by_id.reserve(std::max(want, log->by_id.size() * 2));
  }
  uint64_t off = 0;
  while (off < nbytes) {
    uint32_t len;
    memcpy(&len, buf + off, 4);
    Header h2;
    parse(buf + off + 4, len, &h2);
    log->index_record(base + off, len, h2, fresh_ids);
    off += 4 + len;
  }
  if (!log->ensure_mapped()) log->broken = true;
  // amortized snapshot: bounds both crash-replay work and the close-
  // time snapshot write after a bulk ingest
  if (!log->broken &&
      log->file_size - log->snapshot_covered >= kSnapshotInterval)
    write_index_snapshot(log);
  return n;
}

}  // namespace

// ---------------------------------------------------------------------------
// JSON row ingest — the live event-server lane without per-row Python
// objects (the role of EventAPI's request pipeline,
// data/.../api/EventAPI.scala:209, rebuilt as a native batch encoder:
// one call parses the API-format JSON array, validates each row by the
// EventValidation contract (Event.scala:69-116), packs wire records and
// appends them under one lock + one fsync, with the GIL released).
// ---------------------------------------------------------------------------

namespace {

// per-row validation error codes; messages live in the Python binding
// and mirror data/event.py validate_event
enum RowErr : uint8_t {
  kRowOk = 0,
  kMissingEvent = 1,
  kMissingEntityType = 2,
  kMissingEntityId = 3,
  kEmptyEvent = 4,
  kEmptyEntityType = 5,
  kEmptyEntityId = 6,
  kTargetTogether = 7,
  kEmptyTargetType = 8,
  kEmptyTargetId = 9,
  kUnsetNeedsProps = 10,
  kReservedEventName = 11,
  kSpecialHasTarget = 12,
  kReservedEntityType = 13,
  kReservedTargetType = 14,
  kReservedPropertyKey = 15,
  kBadTime = 16,
  kRowNotObject = 17,
  kTooLong = 18,  // a string field exceeds the u16 wire limit
};

struct JsonCur {
  const char* p;
  const char* end;
  bool ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
    return p < end;
  }
  bool lit(char c) {
    if (!ws() || *p != c) return false;
    ++p;
    return true;
  }
  char peek() { return ws() ? *p : '\0'; }
};

int hex_nibble(char c) {
  if (c >= '0' && c <= '9') return c - '0';
  if (c >= 'a' && c <= 'f') return c - 'a' + 10;
  if (c >= 'A' && c <= 'F') return c - 'A' + 10;
  return -1;
}

// raw contents between the quotes (escapes untouched but VALIDATED);
// cursor must be AT the opening quote
bool scan_quoted(JsonCur& c, std::string_view* out, bool* has_escape) {
  if (c.p >= c.end || *c.p != '"') return false;
  ++c.p;
  const char* s = c.p;
  *has_escape = false;
  while (c.p < c.end) {
    unsigned char ch = static_cast<unsigned char>(*c.p);
    if (ch == '"') {
      *out = std::string_view(s, static_cast<size_t>(c.p - s));
      ++c.p;
      return true;
    }
    if (ch < 0x20) return false;  // RFC 8259: raw control chars are
    // invalid in strings — json.loads rejects them, and an accepted
    // raw slice would poison every later read
    if (ch == '\\') {
      // escapes must be VALID even when the slice is stored raw:
      // json.loads rejects \q / bad \uXXXX, so an unvalidated pass
      // here would store a slice the read path cannot decode
      *has_escape = true;
      if (c.p + 1 >= c.end) return false;
      char e = c.p[1];
      if (e == '"' || e == '\\' || e == '/' || e == 'b' || e == 'f' ||
          e == 'n' || e == 'r' || e == 't') {
        c.p += 2;
        continue;
      }
      if (e == 'u') {
        if (c.p + 6 > c.end) return false;
        for (int k = 2; k < 6; ++k)
          if (hex_nibble(c.p[k]) < 0) return false;
        c.p += 6;
        continue;
      }
      return false;
    }
    ++c.p;
  }
  return false;
}

// resolve JSON escapes (incl. \uXXXX with surrogate pairs) to UTF-8
bool unescape(std::string_view raw, std::string* out) {
  out->clear();
  out->reserve(raw.size());
  for (size_t i = 0; i < raw.size();) {
    char ch = raw[i];
    if (ch != '\\') {
      out->push_back(ch);
      ++i;
      continue;
    }
    if (i + 1 >= raw.size()) return false;
    char e = raw[i + 1];
    i += 2;
    switch (e) {
      case '"': out->push_back('"'); break;
      case '\\': out->push_back('\\'); break;
      case '/': out->push_back('/'); break;
      case 'b': out->push_back('\b'); break;
      case 'f': out->push_back('\f'); break;
      case 'n': out->push_back('\n'); break;
      case 'r': out->push_back('\r'); break;
      case 't': out->push_back('\t'); break;
      case 'u': {
        if (i + 4 > raw.size()) return false;
        uint32_t cp = 0;
        for (int k = 0; k < 4; ++k) {
          int v = hex_nibble(raw[i + k]);
          if (v < 0) return false;
          cp = cp * 16 + static_cast<uint32_t>(v);
        }
        i += 4;
        if (cp >= 0xD800 && cp <= 0xDBFF) {  // high surrogate
          if (i + 6 > raw.size() || raw[i] != '\\' || raw[i + 1] != 'u')
            return false;
          uint32_t lo = 0;
          for (int k = 0; k < 4; ++k) {
            int v = hex_nibble(raw[i + 2 + k]);
            if (v < 0) return false;
            lo = lo * 16 + static_cast<uint32_t>(v);
          }
          if (lo < 0xDC00 || lo > 0xDFFF) return false;
          cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
          i += 6;
        } else if (cp >= 0xDC00 && cp <= 0xDFFF) {
          return false;  // lone low surrogate
        }
        if (cp < 0x80) {
          out->push_back(static_cast<char>(cp));
        } else if (cp < 0x800) {
          out->push_back(static_cast<char>(0xC0 | (cp >> 6)));
          out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
        } else if (cp < 0x10000) {
          out->push_back(static_cast<char>(0xE0 | (cp >> 12)));
          out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
          out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
        } else {
          out->push_back(static_cast<char>(0xF0 | (cp >> 18)));
          out->push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
          out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
          out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
        }
        break;
      }
      default:
        return false;
    }
  }
  return true;
}

bool get_string(JsonCur& c, std::string* out) {
  std::string_view raw;
  bool esc;
  if (!c.ws() || !scan_quoted(c, &raw, &esc)) return false;
  if (!esc) {
    out->assign(raw.data(), raw.size());
    return true;
  }
  return unescape(raw, out);
}

// Skip (and optionally capture the raw slice of) any JSON value —
// STRICT grammar: captured slices are stored verbatim in the record's
// extra blob and re-parsed by json.loads on every read, so anything
// json.loads would reject must be rejected HERE (a stored malformed
// slice would poison every later read of the app: a joint-depth scan
// would accept '[}' and 'truex').
bool skip_value(JsonCur& c, std::string_view* raw_out, int depth = 0) {
  if (depth > 64 || !c.ws()) return false;  // recursion bound
  const char* s = c.p;
  char ch = *c.p;
  if (ch == '"') {
    std::string_view sv;
    bool e;
    if (!scan_quoted(c, &sv, &e)) return false;
  } else if (ch == '{') {
    ++c.p;
    bool first = true;
    while (true) {
      if (!c.ws()) return false;
      if (*c.p == '}') {
        ++c.p;
        break;
      }
      if (!first) {
        if (*c.p != ',') return false;
        ++c.p;
        if (!c.ws()) return false;
      }
      first = false;
      std::string_view k;
      bool e;
      if (!scan_quoted(c, &k, &e)) return false;
      if (!c.lit(':')) return false;
      if (!skip_value(c, nullptr, depth + 1)) return false;
    }
  } else if (ch == '[') {
    ++c.p;
    bool first = true;
    while (true) {
      if (!c.ws()) return false;
      if (*c.p == ']') {
        ++c.p;
        break;
      }
      if (!first) {
        if (*c.p != ',') return false;
        ++c.p;
      }
      first = false;
      if (!skip_value(c, nullptr, depth + 1)) return false;
    }
  } else if (ch == 't') {
    if (c.end - c.p < 4 || memcmp(c.p, "true", 4) != 0) return false;
    c.p += 4;
  } else if (ch == 'f') {
    if (c.end - c.p < 5 || memcmp(c.p, "false", 5) != 0) return false;
    c.p += 5;
  } else if (ch == 'n') {
    if (c.end - c.p < 4 || memcmp(c.p, "null", 4) != 0) return false;
    c.p += 4;
  } else {
    // number: -?int frac? exp? (RFC 8259)
    if (ch == '-') ++c.p;
    if (c.p >= c.end || *c.p < '0' || *c.p > '9') return false;
    if (*c.p == '0') {
      ++c.p;
    } else {
      while (c.p < c.end && *c.p >= '0' && *c.p <= '9') ++c.p;
    }
    if (c.p < c.end && *c.p == '.') {
      ++c.p;
      if (c.p >= c.end || *c.p < '0' || *c.p > '9') return false;
      while (c.p < c.end && *c.p >= '0' && *c.p <= '9') ++c.p;
    }
    if (c.p < c.end && (*c.p == 'e' || *c.p == 'E')) {
      ++c.p;
      if (c.p < c.end && (*c.p == '+' || *c.p == '-')) ++c.p;
      if (c.p >= c.end || *c.p < '0' || *c.p > '9') return false;
      while (c.p < c.end && *c.p >= '0' && *c.p <= '9') ++c.p;
    }
  }
  // a value must terminate at a structural boundary, never run into
  // trailing junk ('truex', '1.5abc')
  if (c.p < c.end) {
    char t = *c.p;
    if (t != ',' && t != '}' && t != ']' && t != ' ' && t != '\t' &&
        t != '\n' && t != '\r')
      return false;
  }
  if (raw_out) *raw_out = std::string_view(s, static_cast<size_t>(c.p - s));
  return true;
}

// days-from-civil (public-domain Hinnant algorithm) for ISO parsing
int64_t days_from_civil(int64_t y, unsigned m, unsigned d) {
  y -= m <= 2;
  const int64_t era = (y >= 0 ? y : y - 399) / 400;
  const unsigned yoe = static_cast<unsigned>(y - era * 400);
  const unsigned doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  const unsigned doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + static_cast<int64_t>(doe) - 719468;
}

bool two_digits(std::string_view s, size_t at, unsigned* out) {
  if (at + 2 > s.size() || s[at] < '0' || s[at] > '9' || s[at + 1] < '0' ||
      s[at + 1] > '9')
    return false;
  *out = static_cast<unsigned>((s[at] - '0') * 10 + (s[at + 1] - '0'));
  return true;
}

// Parse the dashed ISO-8601 subset the API contract uses:
//   YYYY-MM-DD([T ]HH:MM(:SS(.ffffff)?)?)?(Z|±HH(:)?MM)?
// Returns 0 ok, 1 invalid (Python's parser would reject it too),
// 2 unsupported shape (fall back to the Python path, which accepts
// more ISO variants than this fast lane).
int parse_iso_us(std::string_view s, int64_t* out_us, int64_t* offset_us) {
  *offset_us = 0;
  if (s.size() < 10) return 2;
  for (int k : {0, 1, 2, 3})
    if (s[k] < '0' || s[k] > '9') return 2;
  if (s[4] != '-' || s[7] != '-') return 2;
  unsigned month, day;
  int64_t year = (s[0] - '0') * 1000 + (s[1] - '0') * 100 + (s[2] - '0') * 10 +
                 (s[3] - '0');
  if (!two_digits(s, 5, &month) || !two_digits(s, 8, &day)) return 2;
  if (month < 1 || month > 12 || day < 1) return 1;
  static const unsigned kDays[12] = {31, 28, 31, 30, 31, 30,
                                     31, 31, 30, 31, 30, 31};
  unsigned dmax = kDays[month - 1];
  if (month == 2 && (year % 4 == 0 && (year % 100 != 0 || year % 400 == 0)))
    dmax = 29;
  if (day > dmax) return 1;  // fromisoformat rejects impossible dates too
  size_t i = 10;
  unsigned hh = 0, mm = 0, ss = 0;
  int64_t frac_us = 0;
  if (i < s.size() && (s[i] == 'T' || s[i] == ' ')) {
    ++i;
    if (!two_digits(s, i, &hh)) return 2;
    i += 2;
    if (i >= s.size() || s[i] != ':') return 2;
    ++i;
    if (!two_digits(s, i, &mm)) return 2;
    i += 2;
    if (i < s.size() && s[i] == ':') {
      ++i;
      if (!two_digits(s, i, &ss)) return 2;
      i += 2;
      if (i < s.size() && s[i] == '.') {
        ++i;
        size_t fs = i;
        int64_t v = 0;
        while (i < s.size() && s[i] >= '0' && s[i] <= '9') {
          if (i - fs < 6) v = v * 10 + (s[i] - '0');
          ++i;
        }
        size_t ndig = i - fs;
        if (ndig == 0 || ndig > 6) return 1;  // fromisoformat rejects too
        for (size_t k = ndig; k < 6; ++k) v *= 10;
        frac_us = v;
      }
    }
    if (hh > 23 || mm > 59 || ss > 59) return 1;
  }
  if (i < s.size()) {  // timezone designator
    char z = s[i];
    if (z == 'Z') {
      ++i;
    } else if (z == '+' || z == '-') {
      ++i;
      unsigned oh, om = 0;
      if (!two_digits(s, i, &oh)) return 2;
      i += 2;
      if (i < s.size() && s[i] == ':') ++i;
      if (i < s.size()) {
        if (!two_digits(s, i, &om)) return 2;
        i += 2;
      }
      if (oh > 23 || om > 59) return 1;
      int64_t off = (static_cast<int64_t>(oh) * 60 + om) * 60 * 1000000LL;
      *offset_us = (z == '-') ? -off : off;
    } else {
      return 2;
    }
  }
  if (i != s.size()) return 2;
  int64_t days = days_from_civil(year, month, day);
  int64_t local_us = days * 86400000000LL +
                     (static_cast<int64_t>(hh) * 3600 + mm * 60 + ss) *
                         1000000LL +
                     frac_us;
  *out_us = local_us - *offset_us;
  return 0;
}

bool reserved_prefix(std::string_view s) {
  return (!s.empty() && s[0] == '$') ||
         (s.size() >= 4 && s.compare(0, 4, "pio_") == 0);
}

bool is_special_event(std::string_view s) {
  return s == "$set" || s == "$unset" || s == "$delete";
}

// one parsed row (string storage owned by the caller-scoped strings)
struct JsonRow {
  std::string event, etype, eid, ttype, tid;
  bool has_ttype = false, has_tid = false;
  std::string_view props_raw;   // raw {...} slice, empty = absent
  bool props_empty = true;
  bool props_reserved_key = false;
  uint8_t err = 0;              // deferred mid-parse row error (kBadTime)
  std::string_view time_raw;    // raw quoted eventTime value (with quotes)
  std::string_view ctime_raw;
  std::string_view tags_raw;    // raw [...] slice
  std::string_view prid_raw;    // raw quoted prId
  int64_t t_us = 0, c_us = 0;
  int64_t t_off_us = 0, c_off_us = 0;
  bool has_time = false, has_ctime = false;
};

// parse one event object; returns 0 ok, -2 unsupported, or a RowErr > 0
// (the row is skipped but parsing continues at the object end)
int parse_row(JsonCur& c, JsonRow* row) {
  if (c.peek() != '{') return kRowNotObject;
  ++c.p;
  bool first = true;
  bool saw_event = false, saw_etype = false, saw_eid = false;
  while (true) {
    if (!c.ws()) return -2;
    if (*c.p == '}') {
      ++c.p;
      break;
    }
    if (!first) {
      // strict RFC-8259 member separator, same grammar as skip_value's
      // object branch: a missing comma must reject (fallback lane 400s
      // it), never silently accept what json.loads would refuse
      if (*c.p != ',') return -2;
      ++c.p;
      if (!c.ws()) return -2;
    }
    first = false;
    std::string key;
    if (!get_string(c, &key)) return -2;
    if (!c.lit(':')) return -2;
    if (key == "event") {
      if (!get_string(c, &row->event)) return -2;
      saw_event = true;
    } else if (key == "entityType") {
      if (!get_string(c, &row->etype)) return -2;
      saw_etype = true;
    } else if (key == "entityId") {
      if (!get_string(c, &row->eid)) return -2;
      saw_eid = true;
    } else if (key == "targetEntityType") {
      if (c.peek() == 'n') {  // null -> absent (from_dict d.get semantics)
        if (!skip_value(c, nullptr)) return -2;
      } else {
        if (!get_string(c, &row->ttype)) return -2;
        row->has_ttype = true;
      }
    } else if (key == "targetEntityId") {
      if (c.peek() == 'n') {
        if (!skip_value(c, nullptr)) return -2;
      } else {
        if (!get_string(c, &row->tid)) return -2;
        row->has_tid = true;
      }
    } else if (key == "properties") {
      char pk = c.peek();
      if (pk == 'n') {
        if (!skip_value(c, nullptr)) return -2;  // null -> absent
      } else if (pk != '{') {
        return -2;  // non-object properties: let Python shape the error
      } else {
        // walk the top level: reserved-prefix key check + emptiness,
        // then keep the raw slice verbatim (no re-serialization)
        const char* start = c.p;
        ++c.p;
        bool pfirst = true;
        while (true) {
          if (!c.ws()) return -2;
          if (*c.p == '}') {
            ++c.p;
            break;
          }
          if (!pfirst) {
            // strict comma: the raw slice is stored VERBATIM and
            // re-read with json.loads — accepting {"a":1 "b":2} here
            // would poison every later read of this app (get/find/
            // training all json.loads the stored blob)
            if (*c.p != ',') return -2;
            ++c.p;
            if (!c.ws()) return -2;
          }
          pfirst = false;
          std::string_view kraw;
          bool kesc;
          if (!scan_quoted(c, &kraw, &kesc)) return -2;
          if (kesc) return -2;  // escaped key could hide a prefix: fallback
          if (reserved_prefix(kraw)) row->props_reserved_key = true;
          row->props_empty = false;
          if (!c.lit(':')) return -2;
          if (!skip_value(c, nullptr)) return -2;
        }
        row->props_raw =
            std::string_view(start, static_cast<size_t>(c.p - start));
      }
    } else if (key == "eventTime" || key == "creationTime") {
      if (!c.ws()) return -2;
      std::string_view raw;
      bool is_ctime = key[0] == 'c';
      if (*c.p == '"') {
        std::string_view sv;
        bool esc;
        const char* start = c.p;
        if (!scan_quoted(c, &sv, &esc)) return -2;
        if (esc) return -2;
        raw = std::string_view(start, static_cast<size_t>(c.p - start));
        int64_t us, off;
        int rc = parse_iso_us(sv, &us, &off);
        if (rc == 2) return -2;
        if (rc == 1) {
          // deferred: the object must still be consumed to its end so
          // the array parse stays in sync for the rows after this one
          row->err = kBadTime;
          us = 0;
          off = 0;
        }
        if (is_ctime) {
          row->c_us = us;
          row->c_off_us = off;
          row->ctime_raw = raw;
          row->has_ctime = true;
        } else {
          row->t_us = us;
          row->t_off_us = off;
          row->time_raw = raw;
          row->has_time = true;
        }
      } else {
        // epoch millis (int or float), the SDKs' alternative form
        std::string_view num;
        if (!skip_value(c, &num)) return -2;
        char tmp[64];
        if (num.size() >= sizeof(tmp)) return -2;
        memcpy(tmp, num.data(), num.size());
        tmp[num.size()] = 0;
        char* endp = nullptr;
        double ms = strtod(tmp, &endp);
        if (endp != tmp + num.size()) return -2;
        int64_t us = static_cast<int64_t>(ms * 1000.0);
        if (is_ctime) {
          row->c_us = us;
          row->has_ctime = true;
        } else {
          row->t_us = us;
          row->has_time = true;
        }
      }
    } else if (key == "tags") {
      if (c.peek() == 'n') {
        if (!skip_value(c, nullptr)) return -2;
      } else {
        if (c.peek() != '[') return -2;
        if (!skip_value(c, &row->tags_raw)) return -2;
        if (row->tags_raw == "[]") row->tags_raw = {};
      }
    } else if (key == "prId") {
      if (c.peek() == 'n') {
        if (!skip_value(c, nullptr)) return -2;
      } else {
        if (c.peek() != '"') return -2;
        if (!skip_value(c, &row->prid_raw)) return -2;
      }
    } else if (key == "eventId") {
      // a caller-stamped id breaks the fresh-ids lazy-index invariant:
      // that lane (replicated writes) stays on the Python path
      if (c.peek() == 'n') {
        if (!skip_value(c, nullptr)) return -2;
      } else {
        return -2;
      }
    } else {
      if (!skip_value(c, nullptr)) return -2;  // unknown keys ignored
    }
  }
  if (!saw_event) return kMissingEvent;
  if (!saw_etype) return kMissingEntityType;
  if (!saw_eid) return kMissingEntityId;
  // the binding returns event names / entity types as NUL-joined
  // buffers: an embedded \u0000 would misalign every later row, so
  // that (pathological) shape goes to the Python path
  if (row->event.find('\0') != std::string::npos ||
      row->etype.find('\0') != std::string::npos)
    return -2;
  return row->err;
}

// the EventValidation contract (Event.scala:69-116 / data/event.py)
uint8_t validate_row(const JsonRow& r) {
  if (r.event.empty()) return kEmptyEvent;
  if (r.etype.empty()) return kEmptyEntityType;
  if (r.eid.empty()) return kEmptyEntityId;
  if (r.has_ttype != r.has_tid) return kTargetTogether;
  if (r.has_ttype && r.ttype.empty()) return kEmptyTargetType;
  if (r.has_tid && r.tid.empty()) return kEmptyTargetId;
  if (r.event == "$unset" && r.props_empty) return kUnsetNeedsProps;
  if (reserved_prefix(r.event) && !is_special_event(r.event))
    return kReservedEventName;
  if (is_special_event(r.event) && r.has_tid) return kSpecialHasTarget;
  if (reserved_prefix(r.etype) && r.etype != "pio_pr")
    return kReservedEntityType;
  if (r.has_ttype && reserved_prefix(r.ttype) && r.ttype != "pio_pr")
    return kReservedTargetType;
  if (r.props_reserved_key) return kReservedPropertyKey;
  if (r.event.size() >= kAbsent || r.etype.size() >= kAbsent ||
      r.eid.size() >= kAbsent || r.ttype.size() >= kAbsent ||
      r.tid.size() >= kAbsent)
    return kTooLong;
  return kRowOk;
}

// strict UTF-8 validation (DFA-free scalar scan): the Python lane's
// json.loads refuses invalid UTF-8, and anything appended here must
// decode again on the read path
bool valid_utf8(const uint8_t* p, uint64_t n) {
  uint64_t i = 0;
  while (i < n) {
    uint8_t c = p[i];
    if (c < 0x80) { ++i; continue; }
    int extra;
    uint32_t cp;
    if ((c & 0xE0) == 0xC0) { extra = 1; cp = c & 0x1F; }
    else if ((c & 0xF0) == 0xE0) { extra = 2; cp = c & 0x0F; }
    else if ((c & 0xF8) == 0xF0) { extra = 3; cp = c & 0x07; }
    else return false;
    if (i + extra >= n) return false;
    for (int k = 1; k <= extra; ++k) {
      if ((p[i + k] & 0xC0) != 0x80) return false;
      cp = (cp << 6) | (p[i + k] & 0x3F);
    }
    if (extra == 1 && cp < 0x80) return false;          // overlong
    if (extra == 2 && cp < 0x800) return false;
    if (extra == 3 && cp < 0x10000) return false;
    if (cp > 0x10FFFF || (cp >= 0xD800 && cp <= 0xDFFF)) return false;
    i += 1 + extra;
  }
  return true;
}

}  // namespace

// Native live-lane ingest: one call takes the API-format JSON array the
// event server receives, validates, packs and appends — no per-row
// Python work. Returns rows APPENDED (valid rows), with *out_n = total
// rows parsed; or -2 (unsupported construct anywhere: caller falls back
// to the Python path), -3 (malformed JSON), -4 (strict mode and some
// row failed validation: NOTHING appended; first bad row's code in
// *out_n's row slot... see binding), -1 (I/O error). Outputs (malloc'd,
// el_free): ids = n*16 raw bytes (zeroed for failed rows), codes = n
// RowErr bytes, names/etypes = NUL-joined per-row event names and
// entity types (for stats + whitelists).
int64_t el_append_json(void* h, const uint8_t* body, uint64_t nbytes,
                       int64_t now_us, int32_t strict,
                       uint8_t** out_ids, uint8_t** out_codes,
                       uint8_t** out_names, uint64_t* out_names_bytes,
                       uint8_t** out_etypes, uint64_t* out_etypes_bytes,
                       int64_t* out_n) {
  Log* log = static_cast<Log*>(h);
  *out_ids = nullptr;
  *out_codes = nullptr;
  *out_names = nullptr;
  *out_etypes = nullptr;
  *out_n = 0;
  if (!valid_utf8(body, nbytes)) return -3;  // json.loads parity
  JsonCur c{reinterpret_cast<const char*>(body),
            reinterpret_cast<const char*>(body) + nbytes};
  if (!c.lit('[')) return -3;

  std::mt19937_64 rng(std::random_device{}() ^
                      static_cast<uint64_t>(now_us) ^
                      reinterpret_cast<uintptr_t>(h));
  std::vector<uint8_t> buf;
  buf.reserve(nbytes + (nbytes >> 2));
  std::vector<uint8_t> ids;
  std::vector<uint8_t> codes;
  std::string names_join, etypes_join;
  int64_t n_valid = 0;

  bool first = true;
  while (true) {
    if (!c.ws()) return -3;
    if (*c.p == ']') {
      ++c.p;
      break;
    }
    if (!first) {
      if (*c.p != ',') return -3;
      ++c.p;
      // a comma commits to another element: '[{...},]' is a json.loads
      // error and must not be acked (strict RFC-8259)
      if (!c.ws()) return -3;
      if (*c.p == ']') return -3;
    }
    first = false;
    if (c.peek() != '{') {
      // non-object element: a per-row 400 like the Python path's
      // "event must be a JSON object", never a whole-batch failure
      if (!skip_value(c, nullptr)) return -3;
      codes.push_back(kRowNotObject);
      names_join.push_back('\0');
      etypes_join.push_back('\0');
      if (strict) {
        *out_n = static_cast<int64_t>(codes.size());
        uint8_t* cd = static_cast<uint8_t*>(malloc(codes.size()));
        if (cd) memcpy(cd, codes.data(), codes.size());
        *out_codes = cd;
        return -4;
      }
      ids.insert(ids.end(), 16, 0);
      continue;
    }
    JsonRow row;
    int rc = parse_row(c, &row);
    if (rc == -2) return -2;
    uint8_t code = rc > 0 ? static_cast<uint8_t>(rc) : validate_row(row);
    codes.push_back(code);
    names_join += row.event;
    names_join.push_back('\0');
    etypes_join += row.etype;
    etypes_join.push_back('\0');
    if (code != kRowOk) {
      if (strict) {
        *out_n = static_cast<int64_t>(codes.size());
        // surface the code via the codes buffer in strict mode too
        uint8_t* cd = static_cast<uint8_t*>(malloc(codes.size()));
        if (cd) memcpy(cd, codes.data(), codes.size());
        *out_codes = cd;
        return -4;
      }
      ids.insert(ids.end(), 16, 0);
      continue;
    }
    // pack the wire record (format documented at the top of this file)
    std::string extra;
    {
      auto add = [&extra](const char* k, std::string_view raw) {
        extra += extra.empty() ? "{" : ",";
        extra += '"';
        extra += k;
        extra += "\":";
        extra.append(raw.data(), raw.size());
      };
      if (row.has_time && row.t_off_us != 0) add("et", row.time_raw);
      if (row.has_ctime && row.c_off_us != 0) add("ct", row.ctime_raw);
      if (!row.props_raw.empty()) add("p", row.props_raw);
      if (!row.tags_raw.empty()) add("t", row.tags_raw);
      if (!row.prid_raw.empty()) add("pr", row.prid_raw);
      if (!extra.empty()) extra += '}';
    }
    int64_t t_us = row.has_time ? row.t_us : now_us;
    int64_t c_us = row.has_ctime ? row.c_us : now_us;
    uint32_t l_ev = static_cast<uint32_t>(row.event.size());
    uint32_t l_et = static_cast<uint32_t>(row.etype.size());
    uint32_t l_ei = static_cast<uint32_t>(row.eid.size());
    uint32_t l_tt = row.has_ttype ? static_cast<uint32_t>(row.ttype.size()) : 0;
    uint32_t l_ti = row.has_tid ? static_cast<uint32_t>(row.tid.size()) : 0;
    uint32_t l_ex = static_cast<uint32_t>(extra.size());
    uint32_t rec_len = kHeaderLen + l_ev + l_et + l_ei + l_tt + l_ti + l_ex;
    size_t base = buf.size();
    buf.resize(base + 4 + rec_len);
    uint8_t* p = buf.data() + base;
    memcpy(p, &rec_len, 4);
    p += 4;
    uint64_t id_hi = rng(), id_lo = rng();
    memcpy(p, &id_hi, 8);
    memcpy(p + 8, &id_lo, 8);
    ids.insert(ids.end(), p, p + 16);
    memcpy(p + 16, &t_us, 8);
    memcpy(p + 24, &c_us, 8);
    uint16_t u16;
    u16 = static_cast<uint16_t>(l_ev); memcpy(p + 32, &u16, 2);
    u16 = static_cast<uint16_t>(l_et); memcpy(p + 34, &u16, 2);
    u16 = static_cast<uint16_t>(l_ei); memcpy(p + 36, &u16, 2);
    u16 = row.has_ttype ? static_cast<uint16_t>(l_tt) : kAbsent;
    memcpy(p + 38, &u16, 2);
    u16 = row.has_tid ? static_cast<uint16_t>(l_ti) : kAbsent;
    memcpy(p + 40, &u16, 2);
    memcpy(p + 42, &l_ex, 4);
    uint8_t* s = p + kHeaderLen;
    memcpy(s, row.event.data(), l_ev); s += l_ev;
    memcpy(s, row.etype.data(), l_et); s += l_et;
    memcpy(s, row.eid.data(), l_ei); s += l_ei;
    if (row.has_ttype) { memcpy(s, row.ttype.data(), l_tt); s += l_tt; }
    if (row.has_tid) { memcpy(s, row.tid.data(), l_ti); s += l_ti; }
    if (l_ex) memcpy(s, extra.data(), l_ex);
    ++n_valid;
  }
  if (c.ws()) return -3;  // trailing garbage after the array

  int64_t n_rows = static_cast<int64_t>(codes.size());
  if (n_valid > 0) {
    int64_t appended =
        append_packed(log, buf.data(), buf.size(), n_valid, /*fresh_ids=*/true);
    if (appended != n_valid) return -1;
  }
  uint8_t* oi = static_cast<uint8_t*>(malloc(ids.size() ? ids.size() : 1));
  uint8_t* oc = static_cast<uint8_t*>(malloc(codes.size() ? codes.size() : 1));
  uint8_t* on = static_cast<uint8_t*>(
      malloc(names_join.size() ? names_join.size() : 1));
  uint8_t* oe = static_cast<uint8_t*>(
      malloc(etypes_join.size() ? etypes_join.size() : 1));
  if (!oi || !oc || !on || !oe) {
    free(oi); free(oc); free(on); free(oe);
    return -1;
  }
  memcpy(oi, ids.data(), ids.size());
  memcpy(oc, codes.data(), codes.size());
  memcpy(on, names_join.data(), names_join.size());
  memcpy(oe, etypes_join.data(), etypes_join.size());
  *out_ids = oi;
  *out_codes = oc;
  *out_names = on;
  *out_names_bytes = names_join.size();
  *out_etypes = oe;
  *out_etypes_bytes = etypes_join.size();
  *out_n = n_rows;
  return n_valid;
}

// Vectorized row-lane append — the native bulk call behind
// EventLogEventStore.insert_batch's fast lane. The Python side hands
// over COLUMN streams (per-field concatenated bytes + exact prefix
// offsets, times as int64 arrays, presence flags, ids as n*16 raw
// bytes) assembled with numpy/bytes-join at C speed; this call packs
// every wire record and appends them under ONE lock + (optional) one
// fsync with the GIL released — replacing the per-row struct.pack +
// join Python loop that made insert_batch ~30x slower than the
// columnar bulk lane (r03).
//
// ``flags`` bit0 = has targetEntityType, bit1 = has targetEntityId.
// Returns rows appended, -1 on I/O error, -2 when a string field
// exceeds the u16 wire limit (the caller maps it to the same error
// the struct.pack('H') overflow used to raise).
int64_t el_append_rows(
    void* h, int64_t n, const uint8_t* ids,
    const int64_t* times_us, const int64_t* ctimes_us,
    const uint8_t* flags,
    const uint8_t* ev_b, const uint64_t* ev_off,
    const uint8_t* et_b, const uint64_t* et_off,
    const uint8_t* ei_b, const uint64_t* ei_off,
    const uint8_t* tt_b, const uint64_t* tt_off,
    const uint8_t* ti_b, const uint64_t* ti_off,
    const uint8_t* ex_b, const uint64_t* ex_off,
    int32_t fresh_ids) {
  Log* log = static_cast<Log*>(h);
  uint64_t total = 0;
  for (int64_t r = 0; r < n; ++r) {
    uint64_t l_ev = ev_off[r + 1] - ev_off[r];
    uint64_t l_et = et_off[r + 1] - et_off[r];
    uint64_t l_ei = ei_off[r + 1] - ei_off[r];
    bool has_tt = flags[r] & 1, has_ti = flags[r] & 2;
    uint64_t l_tt = has_tt ? tt_off[r + 1] - tt_off[r] : 0;
    uint64_t l_ti = has_ti ? ti_off[r + 1] - ti_off[r] : 0;
    uint64_t l_ex = ex_off[r + 1] - ex_off[r];
    if (l_ev >= kAbsent || l_et >= kAbsent || l_ei >= kAbsent ||
        l_tt >= kAbsent || l_ti >= kAbsent || l_ex >= (1ULL << 32))
      return -2;
    total += 4 + kHeaderLen + l_ev + l_et + l_ei + l_tt + l_ti + l_ex;
  }
  std::vector<uint8_t> buf(total);
  uint8_t* p = buf.data();
  for (int64_t r = 0; r < n; ++r) {
    uint32_t l_ev = static_cast<uint32_t>(ev_off[r + 1] - ev_off[r]);
    uint32_t l_et = static_cast<uint32_t>(et_off[r + 1] - et_off[r]);
    uint32_t l_ei = static_cast<uint32_t>(ei_off[r + 1] - ei_off[r]);
    bool has_tt = flags[r] & 1, has_ti = flags[r] & 2;
    uint32_t l_tt = has_tt ? static_cast<uint32_t>(tt_off[r + 1] - tt_off[r]) : 0;
    uint32_t l_ti = has_ti ? static_cast<uint32_t>(ti_off[r + 1] - ti_off[r]) : 0;
    uint32_t l_ex = static_cast<uint32_t>(ex_off[r + 1] - ex_off[r]);
    uint32_t rec_len = kHeaderLen + l_ev + l_et + l_ei + l_tt + l_ti + l_ex;
    memcpy(p, &rec_len, 4);
    p += 4;
    memcpy(p, ids + r * 16, 16);
    memcpy(p + 16, &times_us[r], 8);
    memcpy(p + 24, &ctimes_us[r], 8);
    uint16_t u16;
    u16 = static_cast<uint16_t>(l_ev); memcpy(p + 32, &u16, 2);
    u16 = static_cast<uint16_t>(l_et); memcpy(p + 34, &u16, 2);
    u16 = static_cast<uint16_t>(l_ei); memcpy(p + 36, &u16, 2);
    u16 = has_tt ? static_cast<uint16_t>(l_tt) : kAbsent;
    memcpy(p + 38, &u16, 2);
    u16 = has_ti ? static_cast<uint16_t>(l_ti) : kAbsent;
    memcpy(p + 40, &u16, 2);
    memcpy(p + 42, &l_ex, 4);
    uint8_t* s = p + kHeaderLen;
    memcpy(s, ev_b + ev_off[r], l_ev); s += l_ev;
    memcpy(s, et_b + et_off[r], l_et); s += l_et;
    memcpy(s, ei_b + ei_off[r], l_ei); s += l_ei;
    if (has_tt) { memcpy(s, tt_b + tt_off[r], l_tt); s += l_tt; }
    if (has_ti) { memcpy(s, ti_b + ti_off[r], l_ti); s += l_ti; }
    if (l_ex) memcpy(s, ex_b + ex_off[r], l_ex);
    p += rec_len;
  }
  return append_packed(log, buf.data(), total, n, fresh_ids != 0);
}

// O(1) content fingerprint of the log: (generation, log bytes, record
// count, tombstone count). An append-only log + monotonically renamed
// compaction generations means this quadruple changes whenever the
// data does — the cheap cache key the binned-layout cache uses to skip
// re-reading 20M rows on retrain-with-unchanged-data (the HBase
// region-sequence-id role).
void el_fingerprint(void* h, uint64_t out[4]) {
  Log* log = static_cast<Log*>(h);
  std::shared_lock lk(log->mu);
  out[0] = log->generation;
  out[1] = log->file_size;
  out[2] = log->recs.size();
  out[3] = log->tombs.size();
}

int el_delete(void* h, const uint8_t* id16) {
  Log* log = static_cast<Log*>(h);
  std::unique_lock lk(log->mu);
  if (log->broken) return -1;
  log->ensure_id_index();
  std::string id(reinterpret_cast<const char*>(id16), 16);
  auto it = log->by_id.find(id);
  if (it == log->by_id.end()) return 0;
  // cutoff = current end of log: masks every existing record with this
  // id, while a future re-insert (offset >= cutoff) is live again
  uint8_t entry[24];
  memcpy(entry, id16, 16);
  memcpy(entry + 16, &log->file_size, 8);
  if (write(log->tomb_fd, entry, 24) != 24) return -1;
  if (log->fsync_on_append) fdatasync(log->tomb_fd);
  uint64_t& slot = log->tombs[id];
  if (log->file_size > slot) slot = log->file_size;
  log->by_id.erase(it);
  return 1;
}

// Copies the record with the given id into *out (u32 len + payload).
// Returns total bytes, 0 if absent, -1 on error.
int64_t el_get(void* h, const uint8_t* id16, uint8_t** out) {
  Log* log = static_cast<Log*>(h);
  {
    std::unique_lock ul(log->mu);
    if (log->broken) return -1;
    log->ensure_id_index();
  }
  std::shared_lock lk(log->mu);
  if (log->broken) return -1;
  auto it = log->by_id.find(std::string(reinterpret_cast<const char*>(id16), 16));
  if (it == log->by_id.end()) return 0;
  const RecMeta& m = log->recs[it->second];
  uint64_t total = 4 + m.len;
  uint8_t* buf = static_cast<uint8_t*>(malloc(total));
  if (!buf) return -1;
  memcpy(buf, log->map + m.offset, total);
  *out = buf;
  return static_cast<int64_t>(total);
}

// Filtered scan with PEvents.find semantics: half-open [start, until)
// time window, hash-prefiltered string matches confirmed byte-wise,
// results ordered by (event_time, creation_time, arrival), optional
// reverse + limit. Output: concatenated records; returns the count.
int64_t el_find(void* h, const FindReq* req, uint8_t** out, uint64_t* out_bytes) {
  Log* log = static_cast<Log*>(h);
  ensure_index_for_scan(log);
  std::shared_lock lk(log->mu);
  if (log->broken) return -1;

  std::vector<uint64_t> hits;
  collect_hits(log, req, &hits);

  uint64_t total = 0;
  for (uint64_t i : hits) total += 4 + log->recs[i].len;
  uint8_t* buf = total ? static_cast<uint8_t*>(malloc(total)) : nullptr;
  if (total && !buf) return -1;
  uint64_t w = 0;
  for (uint64_t i : hits) {
    const RecMeta& m = log->recs[i];
    memcpy(buf + w, log->map + m.offset, 4 + m.len);
    w += 4 + m.len;
  }
  *out = buf;
  *out_bytes = total;
  return static_cast<int64_t>(hits.size());
}

// Columnar filtered scan: the bulk training-read path (the role of the
// reference's region-parallel HBase scans feeding RDDs,
// hbase/HBPEvents.scala:48) — matching events come back dict-encoded
// (entity id / target id / event name as int32 codes + concatenated
// dictionaries with exact prefix offsets, first-seen order) plus one
// numeric property extracted from the record's JSON extra
// (`value_prop`; NaN when absent), so a 20M-event read never
// materializes per-event Python objects. Offsets (n_x + 1 uint64s per
// dictionary) make ids containing ANY byte — including NUL — round-trip
// exactly, matching the npz wire format of the REST tier.
// Output arrays are malloc'd; caller frees each with el_free. Rows with
// no target id get tgt_code = -1. Returns the row count, or -1.
int64_t el_find_columnar(
    void* h, const FindReq* req, const char* value_prop, int32_t time_ordered,
    int32_t** ent_codes_out, int32_t** tgt_codes_out,
    int32_t** name_codes_out, double** values_out, int64_t** times_us_out,
    uint8_t** ent_dict_out, uint64_t* ent_dict_bytes, int64_t* n_ent,
    uint8_t** tgt_dict_out, uint64_t* tgt_dict_bytes, int64_t* n_tgt,
    uint8_t** name_dict_out, uint64_t* name_dict_bytes, int64_t* n_names,
    uint64_t** ent_offsets_out, uint64_t** tgt_offsets_out,
    uint64_t** name_offsets_out) {
  Log* log = static_cast<Log*>(h);
  ensure_index_for_scan(log);
  std::shared_lock lk(log->mu);
  if (log->broken) return -1;

  const double nan = std::numeric_limits<double>::quiet_NaN();
  DictEncoder ents, tgts, names;
  ents.codes.reserve(1 << 16);
  tgts.codes.reserve(1 << 16);
  std::vector<int32_t> ent_v, tgt_v, name_v;
  std::vector<double> val_v;
  std::vector<int64_t> time_v;
  // no up-front reserve sized to the log: a selective scan would commit
  // ~28 B/record regardless of matches; amortized growth is fine

  auto emit = [&](const Header& hd) {
    ent_v.push_back(ents.encode(hd.eid, hd.len_eid));
    tgt_v.push_back(hd.tid ? tgts.encode(hd.tid, hd.len_tid) : -1);
    name_v.push_back(names.encode(hd.event, hd.len_event));
    time_v.push_back(hd.time_us);
    val_v.push_back(value_prop ? header_value(hd, value_prop) : nan);
  };

  if (time_ordered || req->limit >= 0) {
    // order (and therefore limit) needs the full hit set first
    std::vector<uint64_t> hits;
    collect_hits(log, req, &hits);
    Header hd;
    for (uint64_t i : hits) {
      parse(log->map + log->recs[i].offset + 4, log->recs[i].len, &hd);
      emit(hd);
    }
  } else {
    // fused fast path (bulk training reads): filter + encode in ONE
    // pass, records in log order, no sort — a 20M-row scan parses each
    // record exactly once (single- or multi-threaded, see fused_scan)
    fused_scan(log, req, value_prop, /*want_times=*/true,
               &ents, &tgts, &names,
               &ent_v, &tgt_v, &name_v, &val_v, &time_v);
  }

  return finish_columns(
      ents, tgts, names, ent_v, tgt_v, name_v, val_v, time_v,
      ent_codes_out, tgt_codes_out, name_codes_out, values_out, times_us_out,
      ent_dict_out, ent_dict_bytes, n_ent,
      tgt_dict_out, tgt_dict_bytes, n_tgt,
      name_dict_out, name_dict_bytes, n_names,
      ent_offsets_out, tgt_offsets_out, name_offsets_out);
}

// Sequence-offset columnar read — the streaming delta lane
// (find_columnar_since): live records [since_rec, end) of generation
// ``since_gen`` matching ``req``, dict-encoded like el_find_columnar
// but in ARRIVAL order with no sort and no limit (the tailer's
// contract is "exactly the live rows appended since the cursor"). The
// advancing cursor
// comes back as (*out_gen, *out_rec) = (generation, record count) —
// the same primitives el_fingerprint exposes — so a cursor survives
// process restarts: reopening replays/loads the index to the same
// record count (a torn tail truncates PAST records away, which the
// past-the-end check below turns into a rebase, never silent loss).
// A cursor from another generation (a compaction renumbered records)
// or past the current end (a crash dropped unsynced appends) cannot be
// mapped onto this log: the scan restarts from record 0 with
// *out_rebased = 1, telling the caller these rows are a RESYNC of the
// whole live set, not a delta.
int64_t el_find_columnar_since(
    void* h, const FindReq* req, const char* value_prop,
    uint64_t since_gen, uint64_t since_rec,
    uint64_t* out_gen, uint64_t* out_rec, int32_t* out_rebased,
    int32_t** ent_codes_out, int32_t** tgt_codes_out,
    int32_t** name_codes_out, double** values_out, int64_t** times_us_out,
    uint8_t** ent_dict_out, uint64_t* ent_dict_bytes, int64_t* n_ent,
    uint8_t** tgt_dict_out, uint64_t* tgt_dict_bytes, int64_t* n_tgt,
    uint8_t** name_dict_out, uint64_t* name_dict_bytes, int64_t* n_names,
    uint64_t** ent_offsets_out, uint64_t** tgt_offsets_out,
    uint64_t** name_offsets_out) {
  Log* log = static_cast<Log*>(h);
  ensure_index_for_scan(log);
  std::shared_lock lk(log->mu);
  if (log->broken) return -1;

  uint64_t start = since_rec;
  *out_rebased = 0;
  if (since_gen != log->generation || since_rec > log->recs.size()) {
    start = 0;
    *out_rebased = 1;
  }
  const double nan = std::numeric_limits<double>::quiet_NaN();
  DictEncoder ents, tgts, names;
  std::vector<int32_t> ent_v, tgt_v, name_v;
  std::vector<double> val_v;
  std::vector<int64_t> time_v;
  FilterCtx ctx = make_filter_ctx(req);
  Header hd;
  const uint64_t nrec = log->recs.size();
  for (uint64_t i = start; i < nrec; ++i) {
    if (!match_rec(log, req, ctx, i, &hd)) continue;
    ent_v.push_back(ents.encode(hd.eid, hd.len_eid));
    tgt_v.push_back(hd.tid ? tgts.encode(hd.tid, hd.len_tid) : -1);
    name_v.push_back(names.encode(hd.event, hd.len_event));
    time_v.push_back(hd.time_us);
    val_v.push_back(value_prop ? header_value(hd, value_prop) : nan);
  }
  *out_gen = log->generation;
  *out_rec = nrec;
  return finish_columns(
      ents, tgts, names, ent_v, tgt_v, name_v, val_v, time_v,
      ent_codes_out, tgt_codes_out, name_codes_out, values_out, times_us_out,
      ent_dict_out, ent_dict_bytes, n_ent,
      tgt_dict_out, tgt_dict_bytes, n_tgt,
      name_dict_out, name_dict_bytes, n_names,
      ent_offsets_out, tgt_offsets_out, name_offsets_out);
}

// Columnar bulk append: the native ingest path behind pio import /
// insert_columnar (the role of the reference's PEvents.write RDD bulk
// writes, hbase/HBPEvents.scala:124) — rows arrive dict-encoded
// (codes + '\0'-joined vocab with prefix offsets) and are packed into
// wire records in C++, so a 20M-event ingest never builds per-event
// Python objects. Event ids are fresh random 16-byte ids; out_ids
// (optional, n*16 bytes caller-allocated) receives them. `values[i]`
// NaN means "no property"; otherwise extra = {"p":{"<value_prop>":v}}.
// Returns rows appended, or -1.
int64_t el_append_columnar(
    void* h, int64_t n,
    const char* entity_type, const char* target_entity_type,
    const char* value_prop,
    const uint8_t* ent_dict, const uint64_t* ent_offsets, int64_t n_ent,
    const uint8_t* tgt_dict, const uint64_t* tgt_offsets, int64_t n_tgt,
    const uint8_t* name_dict, const uint64_t* name_offsets, int64_t n_names,
    const int32_t* ent_codes, const int32_t* tgt_codes,
    const int32_t* name_codes, const int64_t* times_us,
    const double* values, uint8_t* out_ids) {
  Log* log = static_cast<Log*>(h);
  size_t l_etype = strlen(entity_type);
  size_t l_ttype = target_entity_type ? strlen(target_entity_type) : 0;
  size_t l_prop = value_prop ? strlen(value_prop) : 0;
  // u16 header fields: any string length >= 0xFFFF (the kAbsent
  // sentinel) would wrap or alias the framing — fail the whole batch,
  // mirroring the Python row path where struct.pack('H') raises
  if (l_etype >= kAbsent || l_ttype >= kAbsent) return -1;

  int64_t now_us;
  {
    struct timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    now_us = static_cast<int64_t>(ts.tv_sec) * 1000000 + ts.tv_nsec / 1000;
  }
  std::mt19937_64 rng(std::random_device{}() ^
                      static_cast<uint64_t>(now_us) ^
                      reinterpret_cast<uintptr_t>(h));

  std::vector<uint8_t> buf;
  buf.reserve(static_cast<size_t>(n) * 96);
  char extra[96];
  std::unordered_map<double, std::string> fmt_cache;
  for (int64_t r = 0; r < n; ++r) {
    int32_t ec = ent_codes[r];
    if (ec < 0 || ec >= n_ent) return -1;
    const uint8_t* eid = ent_dict + ent_offsets[ec];
    uint32_t l_eid = static_cast<uint32_t>(ent_offsets[ec + 1] - ent_offsets[ec]);
    if (l_eid >= kAbsent) return -1;
    int32_t tc = tgt_codes ? tgt_codes[r] : -1;
    const uint8_t* tid = nullptr;
    uint32_t l_tid = 0;
    if (tc >= 0) {
      if (tc >= n_tgt || !target_entity_type) return -1;
      tid = tgt_dict + tgt_offsets[tc];
      l_tid = static_cast<uint32_t>(tgt_offsets[tc + 1] - tgt_offsets[tc]);
      if (l_tid >= kAbsent) return -1;
    }
    int32_t nc = name_codes[r];
    if (nc < 0 || nc >= n_names) return -1;
    const uint8_t* name = name_dict + name_offsets[nc];
    uint32_t l_name = static_cast<uint32_t>(name_offsets[nc + 1] - name_offsets[nc]);
    if (l_name >= kAbsent) return -1;

    uint32_t l_extra = 0;
    const char* extra_src = extra;
    if (value_prop && values && values[r] == values[r]) {  // not NaN
      // ratings repeat from a tiny value set; format each distinct
      // double once (snprintf %.17g is ~300ns, the cache ~30ns)
      auto it = fmt_cache.find(values[r]);
      if (it == fmt_cache.end()) {
        int w = snprintf(extra, sizeof(extra), "{\"p\":{\"%s\":%.17g}}",
                         value_prop, values[r]);
        if (w <= 0 || static_cast<size_t>(w) >= sizeof(extra)) return -1;
        it = fmt_cache.emplace(values[r], std::string(extra, w)).first;
      }
      extra_src = it->second.data();
      l_extra = static_cast<uint32_t>(it->second.size());
    }

    bool has_target = tc >= 0;
    uint32_t rec_len = kHeaderLen + l_name + l_etype + l_eid +
                       (has_target ? l_ttype + l_tid : 0) + l_extra;
    size_t base = buf.size();
    buf.resize(base + 4 + rec_len);
    uint8_t* p = buf.data() + base;
    memcpy(p, &rec_len, 4);
    p += 4;
    uint64_t id_hi = rng(), id_lo = rng();
    memcpy(p, &id_hi, 8);
    memcpy(p + 8, &id_lo, 8);
    if (out_ids) memcpy(out_ids + r * 16, p, 16);
    memcpy(p + 16, &times_us[r], 8);
    memcpy(p + 24, &now_us, 8);
    uint16_t u16;
    u16 = static_cast<uint16_t>(l_name); memcpy(p + 32, &u16, 2);
    u16 = static_cast<uint16_t>(l_etype); memcpy(p + 34, &u16, 2);
    u16 = static_cast<uint16_t>(l_eid); memcpy(p + 36, &u16, 2);
    u16 = has_target ? static_cast<uint16_t>(l_ttype) : kAbsent; memcpy(p + 38, &u16, 2);
    u16 = has_target ? static_cast<uint16_t>(l_tid) : kAbsent; memcpy(p + 40, &u16, 2);
    memcpy(p + 42, &l_extra, 4);
    uint8_t* s = p + kHeaderLen;
    memcpy(s, name, l_name); s += l_name;
    memcpy(s, entity_type, l_etype); s += l_etype;
    memcpy(s, eid, l_eid); s += l_eid;
    if (has_target) {
      memcpy(s, target_entity_type, l_ttype); s += l_ttype;
      memcpy(s, tid, l_tid); s += l_tid;
    }
    if (l_extra) memcpy(s, extra_src, l_extra);
  }
  // records were built here (fresh ids) — no validation pass, lazy id index
  return append_packed(log, buf.data(), buf.size(), n, /*fresh_ids=*/true);
}

namespace {

double mono_sec() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<double>(ts.tv_sec) + ts.tv_nsec * 1e-9;
}

}  // namespace

// Out-params of el_bin_columnar (mirrored by a ctypes Structure in the
// Python binding — every field is 8 bytes, so the layout is
// padding-free). All pointers are malloc'd/aligned outputs the caller
// frees via el_free; zeroed on entry and on error.
struct BinColumnarOut {
  binlayout::CSide user_side;   // grouped by entity id
  binlayout::CSide item_side;   // grouped by target id
  uint8_t* ent_dict;            // concatenated entity-id bytes
  uint64_t* ent_offsets;        // n_ent + 1 exact prefix offsets
  uint8_t* tgt_dict;
  uint64_t* tgt_offsets;
  int32_t* hold_u;              // held-out COO (skip_mod rows)
  int32_t* hold_i;
  float* hold_v;
  uint64_t ent_dict_bytes;
  uint64_t tgt_dict_bytes;
  int64_t n_ent;
  int64_t n_tgt;
  int64_t n_hold;
  int64_t n_rows;               // kept (binned) interaction rows
  double scan_sec;              // filter+encode+vocab-dump wall time
  double bin_sec;               // value-resolve + plan + fill wall time
};

static void free_bin_columnar(BinColumnarOut* out) {
  binlayout::SideOut u{out->user_side.idx_lo, out->user_side.idx_hi,
                       out->user_side.val_u8, out->user_side.val_f32,
                       out->user_side.mask, out->user_side.seg,
                       out->user_side.counts};
  u.free_all();
  binlayout::SideOut i{out->item_side.idx_lo, out->item_side.idx_hi,
                       out->item_side.val_u8, out->item_side.val_f32,
                       out->item_side.mask, out->item_side.seg,
                       out->item_side.counts};
  i.free_all();
  free(out->ent_dict); free(out->ent_offsets);
  free(out->tgt_dict); free(out->tgt_offsets);
  free(out->hold_u); free(out->hold_i); free(out->hold_v);
  memset(out, 0, sizeof(*out));
}

// The fused ingest->bin lane (zero-copy data path): ONE call takes the
// mmap'd log to both sides' device-ready compressed layouts.
//
//   scan     fused filter + dict-encode in log order (the same code
//            path el_find_columnar's bulk reads use), vocabularies
//            dumped under the shared lock
//   resolve  per-row float32 value: per-event-name overrides (the
//            "buy means rating 4.0" rule, resolved against the name
//            dictionary), NaN -> 0.0 otherwise — exactly the Python
//            template's nan_to_num + np.where
//   filter   rows without a target id are dropped (read_interactions
//            semantics); ``skip_mod > 0`` holds OUT every row whose
//            kept-ordinal % skip_mod == skip_rem (the bench's 5%
//            held-out split) and returns those as COO for evaluation
//   bin      binlayout plan + single-pass compressed fill per side
//            (group axis = entity for user_side, target for
//            item_side), outside the lock so a 20M-row bin never
//            blocks writers
//
// No per-row Python objects, no intermediate f32 val/mask arrays, no
// Event materialization anywhere. Returns kept row count, or -1
// (error/bad index), -2 (allocation), -3 (>24-bit index). seg_len -1 =
// auto; max_len_* -1 = uncapped.
int64_t el_bin_columnar(
    void* h, const FindReq* req, const char* value_prop,
    const char* override_names, const double* override_values,
    int32_t n_overrides, int64_t skip_mod, int64_t skip_rem,
    int64_t seg_len, int64_t max_len_user, int64_t max_len_item,
    int64_t n_shards, int64_t block_size, double row_cost_slots,
    BinColumnarOut* out) {
  Log* log = static_cast<Log*>(h);
  memset(out, 0, sizeof(*out));
  double t0 = mono_sec();
  ensure_index_for_scan(log);

  std::vector<int32_t> ent_v, tgt_v, name_v;
  std::vector<double> val_v;
  std::vector<int64_t> time_v;  // unused (want_times=false)
  std::vector<double> override_by_code;
  int64_t n_ent = 0, n_tgt = 0;
  {
    std::shared_lock lk(log->mu);
    if (log->broken) return -1;
    DictEncoder ents, tgts, names;
    ents.codes.reserve(1 << 16);
    tgts.codes.reserve(1 << 16);
    fused_scan(log, req, value_prop, /*want_times=*/false,
               &ents, &tgts, &names,
               &ent_v, &tgt_v, &name_v, &val_v, &time_v);
    // vocabularies + override resolution must happen under the lock:
    // the encoders key string_views into the mmap'd log
    out->ent_dict = ents.dump(&out->ent_dict_bytes, &out->ent_offsets);
    out->tgt_dict = tgts.dump(&out->tgt_dict_bytes, &out->tgt_offsets);
    if (!out->ent_dict || !out->tgt_dict) {
      free_bin_columnar(out);
      return -2;
    }
    n_ent = static_cast<int64_t>(ents.order.size());
    n_tgt = static_cast<int64_t>(tgts.order.size());
    const double nan = std::numeric_limits<double>::quiet_NaN();
    override_by_code.assign(names.order.size(), nan);
    const char* p = override_names;
    for (int32_t i = 0; i < n_overrides; ++i) {
      size_t l = strlen(p);
      auto it = names.codes.find(std::string_view(p, l));
      if (it != names.codes.end()) override_by_code[it->second] = override_values[i];
      p += l + 1;
    }
  }
  out->n_ent = n_ent;
  out->n_tgt = n_tgt;
  out->scan_sec = mono_sec() - t0;
  t0 = mono_sec();

  // resolve + filter into the kept COO (and the held-out COO)
  const int64_t n_scanned = static_cast<int64_t>(ent_v.size());
  std::vector<int32_t> u_codes, i_codes;
  std::vector<float> vals;
  u_codes.reserve(n_scanned);
  i_codes.reserve(n_scanned);
  vals.reserve(n_scanned);
  std::vector<int32_t> hold_u, hold_i;
  std::vector<float> hold_v;
  int64_t ordinal = 0;
  for (int64_t k = 0; k < n_scanned; ++k) {
    int32_t tc = tgt_v[k];
    if (tc < 0) continue;  // read_interactions drops target-less rows
    double ov = override_by_code.empty()
                    ? std::numeric_limits<double>::quiet_NaN()
                    : override_by_code[name_v[k]];
    float v;
    if (ov == ov) {
      v = static_cast<float>(ov);
    } else {
      double raw = val_v[k];
      v = raw == raw ? static_cast<float>(raw) : 0.0f;  // nan_to_num
    }
    bool held = skip_mod > 0 && (ordinal % skip_mod) == skip_rem;
    ++ordinal;
    if (held) {
      hold_u.push_back(ent_v[k]);
      hold_i.push_back(tc);
      hold_v.push_back(v);
    } else {
      u_codes.push_back(ent_v[k]);
      i_codes.push_back(tc);
      vals.push_back(v);
    }
  }
  // release the scan vectors before the fill allocates its buffers
  ent_v.clear(); ent_v.shrink_to_fit();
  tgt_v.clear(); tgt_v.shrink_to_fit();
  name_v.clear(); name_v.shrink_to_fit();
  val_v.clear(); val_v.shrink_to_fit();

  const int64_t nnz = static_cast<int64_t>(u_codes.size());
  auto bin_side = [&](const std::vector<int32_t>& grp,
                      const std::vector<int32_t>& itm, int64_t n_groups,
                      int64_t max_len, binlayout::CSide* side) -> int {
    std::vector<int64_t> counts(n_groups, 0);
    for (int64_t k = 0; k < nnz; ++k) {
      if (grp[k] < 0 || grp[k] >= n_groups) return -1;
      ++counts[grp[k]];
    }
    binlayout::SidePlan plan;
    binlayout::plan_segmented(std::move(counts), n_groups, seg_len,
                              max_len, n_shards, block_size,
                              row_cost_slots, &plan);
    binlayout::SideOut so;
    int rc = binlayout::fill_compressed(
        grp.data(), itm.data(), vals.data(), nnz, plan, &so);
    if (rc != 0) {
      so.free_all();
      return rc;
    }
    binlayout::export_side(plan, &so, side);
    return 0;
  };
  int rc = bin_side(u_codes, i_codes, n_ent, max_len_user, &out->user_side);
  if (rc == 0)
    rc = bin_side(i_codes, u_codes, n_tgt, max_len_item, &out->item_side);
  if (rc != 0) {
    free_bin_columnar(out);
    return rc == -1 ? -1 : rc;
  }

  if (!hold_u.empty()) {
    out->hold_u = static_cast<int32_t*>(malloc(hold_u.size() * 4));
    out->hold_i = static_cast<int32_t*>(malloc(hold_i.size() * 4));
    out->hold_v = static_cast<float*>(malloc(hold_v.size() * 4));
    if (!out->hold_u || !out->hold_i || !out->hold_v) {
      free_bin_columnar(out);
      return -2;
    }
    memcpy(out->hold_u, hold_u.data(), hold_u.size() * 4);
    memcpy(out->hold_i, hold_i.data(), hold_i.size() * 4);
    memcpy(out->hold_v, hold_v.data(), hold_v.size() * 4);
  }
  out->n_hold = static_cast<int64_t>(hold_u.size());
  out->n_rows = nnz;
  out->bin_sec = mono_sec() - t0;
  return nnz;
}

// Compaction: rewrite the log keeping only LIVE records (drops
// tombstone-masked records and superseded duplicate ids — the space
// HBase reclaims with major compaction), truncate the tombstone file,
// and persist a fresh index snapshot. Record order is preserved.
// Returns the number of records dropped, or -1; before/after log byte
// sizes come back via the out params.
int64_t el_compact(void* h, uint64_t* before_bytes, uint64_t* after_bytes) {
  Log* log = static_cast<Log*>(h);
  std::unique_lock lk(log->mu);
  if (log->broken) return -1;
  log->ensure_id_index();
  *before_bytes = log->file_size;

  if (log->all_live()) {  // nothing to drop
    *after_bytes = log->file_size;
    if (log->file_size != log->snapshot_covered) write_index_snapshot(log);
    return 0;
  }

  uint64_t new_gen = log->generation + 1;
  std::string new_log_path = log_path_for(log->dir, new_gen);
  std::string new_tomb_path = tomb_path_for(log->dir, new_gen);
  int nfd = open(new_log_path.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (nfd < 0) return -1;

  std::vector<RecMeta> new_recs;
  std::unordered_map<std::string, uint64_t> new_by_id;
  new_recs.reserve(log->by_id.size());
  new_by_id.reserve(log->by_id.size());
  uint64_t new_size = 0;
  int64_t dropped = 0;
  bool ok = true;
  // buffered copy: records are contiguous runs of live bytes most of
  // the time; coalesce adjacent live records into one write
  uint64_t run_start = 0, run_len = 0;
  auto flush_run = [&]() {
    if (run_len && ok) ok = write_all(nfd, log->map + run_start, run_len);
    run_len = 0;
  };
  Header hd;
  for (uint64_t i = 0; i < log->recs.size() && ok; ++i) {
    const RecMeta& m = log->recs[i];
    parse(log->map + m.offset + 4, m.len, &hd);
    std::string id(reinterpret_cast<const char*>(hd.id), 16);
    auto it = log->by_id.find(id);
    if (it == log->by_id.end() || it->second != i) {
      ++dropped;
      flush_run();
      continue;
    }
    if (run_len == 0) run_start = m.offset;
    else if (run_start + run_len != m.offset) {
      flush_run();
      run_start = m.offset;
    }
    run_len += 4 + m.len;
    RecMeta nm = m;
    nm.offset = new_size;
    new_by_id.emplace(std::move(id), new_recs.size());
    new_recs.push_back(nm);
    new_size += 4 + m.len;
  }
  flush_run();
  if (ok) ok = fdatasync(nfd) == 0;
  close(nfd);
  // the new generation's tombstone file starts empty
  if (ok) {
    int tfd = open(new_tomb_path.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
    ok = tfd >= 0;
    if (ok) {
      ok = fdatasync(tfd) == 0;
      close(tfd);
    }
  }
  // the new generation's directory entries must be durable BEFORE the
  // commit record can name them (else CURRENT=N could survive a power
  // cut whose log.<N>.bin dirent did not)
  if (ok) ok = fsync_dir(log->dir);
  // commit point: CURRENT now names the new generation. A crash before
  // this line leaves the old generation fully intact (the new files are
  // orphans, removed on next open); a crash after it leaves the
  // compacted log with its empty tombstones — never a mix.
  if (!ok || !commit_generation(log->dir, new_gen)) {
    unlink(new_log_path.c_str());
    unlink(new_tomb_path.c_str());
    return -1;
  }
  // ...and the commit itself must be durable before the OLD generation
  // may disappear (else the old files' unlinks could persist while the
  // CURRENT rename did not, leaving CURRENT=old pointing at nothing)
  fsync_dir(log->dir);

  if (log->map) {
    munmap(log->map, log->map_size);
    log->map = nullptr;
    log->map_size = 0;
  }
  close(log->fd);
  close(log->tomb_fd);
  log->fd = open(new_log_path.c_str(), O_RDWR | O_CREAT | O_APPEND, 0644);
  log->tomb_fd = open(new_tomb_path.c_str(), O_RDWR | O_CREAT | O_APPEND, 0644);
  if (log->fd < 0 || log->tomb_fd < 0) {
    log->broken = true;
    return -1;
  }
  log->generation = new_gen;
  log->file_size = new_size;
  log->recs = std::move(new_recs);
  log->by_id = std::move(new_by_id);
  log->indexed_upto = log->recs.size();
  log->has_dupes = false;
  log->needs_id_verify = false;
  log->tombs.clear();
  log->snapshot_covered = 0;  // the on-disk snapshot is for the old gen
  if (!log->ensure_mapped()) {
    log->broken = true;
    return -1;
  }
  remove_orphan_generations(log->dir, new_gen);
  write_index_snapshot(log);
  *after_bytes = log->file_size;
  return dropped;
}

}  // extern "C"
