// Native subscription table: exact-match map + wildcard trie, mirrored
// from the Python broker tables (emqx_tpu/broker/broker.py) by the
// native server. This is the C++ twin of the host-oracle trie
// (emqx_tpu/router/trie.py — itself the emqx_trie.erl:113-160 walk),
// specialised for the PUBLISH fast path: entries carry the owning
// connection and delivery flags, and a *punt marker* entry means "this
// filter's subscriber cannot be served natively" (shared subscription,
// persistent session, non-native transport, cross-node route, v5
// subscription identifier). A publish whose match set contains any punt
// marker is forwarded to Python verbatim, so native fan-out is only
// ever performed when it is COMPLETE.
//
// Threading: mutated and read exclusively on the host's poll thread
// (Python-side calls enqueue ops that the loop applies in ApplyPending),
// so no locks here.
#pragma once

#include <cstdint>
#include <memory>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace emqx_native {

struct SubEntry {
  uint64_t owner = 0;  // conn id for real entries; opaque token for punts
  uint8_t qos = 0;     // granted (subscription) max qos
  uint8_t flags = 0;   // kSubPunt / kSubNoLocal
};

constexpr uint8_t kSubPunt = 1;     // matched => forward frame to Python
constexpr uint8_t kSubNoLocal = 2;  // MQTT5 no-local: skip the publisher
// Rule tap (round 5): a rule-engine FROM filter compiled into the
// table as a NON-delivering entry. A matched tap neither punts nor
// receives the message — the frame is COPIED up to Python's rule
// runtime asynchronously while native fan-out proceeds, removing the
// broad-rule permit cliff (one FROM '#' rule used to de-permit the
// whole fast path).
constexpr uint8_t kSubRuleTap = 4;
// Remote entry (round 9): a cross-node route whose peer has a native
// trunk link — the third entry kind, sibling of the round-5 punt
// marker. A matched remote entry enqueues the publish onto that peer's
// per-topic-ordered trunk batch (host.cc TrunkEnqueue) instead of
// punting the frame to Python; when the trunk is down (or the qos1
// replay ring is full, or the publish is qos2) the entry behaves
// exactly like a punt marker and the Python forward_fn lane carries
// the message. owner = kTrunkOwnerBase + peer id.
constexpr uint8_t kSubRemote = 8;
// Durable entry (round 10): a persistent session's filter, served by
// the native durable plane instead of a punt marker — the FOURTH entry
// kind, sibling of punt/remote. A matched durable entry neither punts
// nor delivers directly: the publish is appended to the host-side
// message store (store.h) in the per-cycle batched record and shipped
// to Python as ONE kind-10 event, so the publisher and every fast
// subscriber STAY on the fast path while the persistent session gets
// its store marker + Python-side delivery (emqx_persistent_session
// :persist_message semantics below the GIL). owner = a store token
// registered per session id.
constexpr uint8_t kSubDurable = 16;

// A $share group on one filter, natively served: the Python server
// installs one of these ONLY when every member is a fast native
// connection and the node strategy is round_robin (emqx_shared_sub.erl
// :309-379); any other membership shape stays a punt marker. Dispatch
// advances the cursor and skips members whose connection is gone or
// backpressured — the nack/redispatch analogue (:190-217).
struct SharedGroup {
  uint64_t token = 0;              // group identity (interned by Python)
  uint32_t cursor = 0;
  std::vector<SubEntry> members;   // owner = conn id
};

// Split a topic/filter on '/'; MQTT keeps empty levels ("a//b" is three
// levels, the middle one empty) — emqx_topic.erl:words/1 semantics.
inline void SplitLevels(std::string_view s, std::vector<std::string_view>* out) {
  out->clear();
  size_t start = 0;
  for (size_t i = 0; i <= s.size(); i++) {
    if (i == s.size() || s[i] == '/') {
      out->push_back(s.substr(start, i - start));
      start = i + 1;
    }
  }
}

class SubTable {
 public:
  // Insert or update (owner, filter). A second add with the same owner
  // and filter updates qos/flags in place (resubscribe upgrades).
  void Add(uint64_t owner, const std::string& filter, uint8_t qos,
           uint8_t flags) {
    if (filter.find('+') == std::string::npos &&
        filter.find('#') == std::string::npos) {
      if (Upsert(&exact_[filter], owner, qos, flags)) entry_count_++;
      return;
    }
    SplitLevels(filter, &scratch_levels_);
    Node* n = &root_;
    for (size_t i = 0; i < scratch_levels_.size(); i++) {
      std::string_view w = scratch_levels_[i];
      if (w == "#") {
        // '#' is only valid as the last level; store at the node ABOVE
        if (Upsert(&n->hash, owner, qos, flags)) entry_count_++;
        return;
      }
      if (w == "+") {
        if (!n->plus) n->plus = std::make_unique<Node>();
        n = n->plus.get();
      } else {
        auto& kid = n->kids[std::string(w)];
        if (!kid) kid = std::make_unique<Node>();
        n = kid.get();
      }
    }
    if (Upsert(&n->here, owner, qos, flags)) entry_count_++;
  }

  // Remove (owner, filter); returns whether an entry was removed.
  bool Remove(uint64_t owner, const std::string& filter) {
    if (filter.find('+') == std::string::npos &&
        filter.find('#') == std::string::npos) {
      auto it = exact_.find(filter);
      if (it == exact_.end()) return false;
      bool hit = Erase(&it->second, owner);
      if (hit) entry_count_--;
      if (it->second.empty()) exact_.erase(it);
      return hit;
    }
    SplitLevels(filter, &scratch_levels_);
    Node* n = &root_;
    for (size_t i = 0; i < scratch_levels_.size(); i++) {
      std::string_view w = scratch_levels_[i];
      if (w == "#") {
        bool hit = Erase(&n->hash, owner);
        if (hit) entry_count_--;
        return hit;
      }
      if (w == "+") {
        if (!n->plus) return false;
        n = n->plus.get();
      } else {
        auto it = n->kids.find(std::string(w));
        if (it == n->kids.end()) return false;
        n = it->second.get();
      }
    }
    bool hit = Erase(&n->here, owner);
    if (hit) entry_count_--;
    return hit;
    // empty interior nodes are left in place: subscription churn
    // re-creates them constantly and the per-node footprint is tiny
  }

  // Shared-group membership management: token identifies the group,
  // owner the member connection. Empty groups are removed.
  void SharedAdd(uint64_t token, uint64_t owner, const std::string& filter,
                 uint8_t qos, uint8_t flags) {
    SharedGroup* g = FindGroup(filter, token, /*create=*/true);
    if (g) (void)Upsert(&g->members, owner, qos, flags);
  }

  bool SharedRemove(uint64_t token, uint64_t owner,
                    const std::string& filter) {
    SharedGroup* g = FindGroup(filter, token, /*create=*/false);
    if (!g) return false;
    bool hit = Erase(&g->members, owner);
    if (g->members.empty()) DropGroup(filter, token);
    return hit;
  }

  // Append every entry matching `topic` to *out, and every natively
  // served shared group to *groups (mutable: dispatch advances their
  // cursors). The caller guarantees the topic is a plain name (no
  // wildcards, no leading '$' — the fast path punts those before
  // matching, which also gives the MQTT rule that root wildcards must
  // not match $-topics for free).
  void Match(std::string_view topic, std::vector<const SubEntry*>* out,
             std::vector<SharedGroup*>* groups = nullptr) {
    key_scratch_.assign(topic.data(), topic.size());
    auto it = exact_.find(key_scratch_);
    if (it != exact_.end())
      for (const auto& e : it->second) out->push_back(&e);
    if (groups) {
      auto git = exact_groups_.find(key_scratch_);
      if (git != exact_groups_.end())
        for (auto& g : git->second) groups->push_back(&g);
    }
    SplitLevels(topic, &match_levels_);
    MatchNode(&root_, 0, out, groups);
  }

  // Entries + shared groups registered under EXACTLY this filter — the
  // device lane's delivery lookup. The device kernel already did the
  // wildcard walk and returned matched filter STRINGS; delivery then
  // needs only each filter's terminal vectors: an O(1) hash probe for
  // plain names, an O(depth) path walk (no branching) for wildcard
  // filters, instead of the full per-message trie match.
  void MatchFilter(std::string_view filter,
                   std::vector<const SubEntry*>* out,
                   std::vector<SharedGroup*>* groups = nullptr) {
    key_scratch_.assign(filter.data(), filter.size());
    if (key_scratch_.find('+') == std::string::npos &&
        key_scratch_.find('#') == std::string::npos) {
      auto it = exact_.find(key_scratch_);
      if (it != exact_.end())
        for (const auto& e : it->second) out->push_back(&e);
      if (groups) {
        auto git = exact_groups_.find(key_scratch_);
        if (git != exact_groups_.end())
          for (auto& g : git->second) groups->push_back(&g);
      }
      return;
    }
    SplitLevels(key_scratch_, &scratch_levels_);
    Node* n = &root_;
    for (size_t i = 0; i < scratch_levels_.size(); i++) {
      std::string_view w = scratch_levels_[i];
      if (w == "#") {
        for (const auto& e : n->hash) out->push_back(&e);
        if (groups)
          for (auto& g : n->hash_groups) groups->push_back(&g);
        return;
      }
      if (w == "+") {
        if (!n->plus) return;
        n = n->plus.get();
      } else {
        auto it = n->kids.find(std::string(w));
        if (it == n->kids.end()) return;
        n = it->second.get();
      }
    }
    for (const auto& e : n->here) out->push_back(&e);
    if (groups)
      for (auto& g : n->here_groups) groups->push_back(&g);
  }

  size_t exact_count() const { return exact_.size(); }

  // True when no plain (non-shared) entries exist anywhere — interior
  // trie nodes left by removals don't count. O(1) via entry_count_.
  bool Empty() const { return entry_count_ == 0; }

 private:
  struct Node {
    std::unordered_map<std::string, std::unique_ptr<Node>> kids;
    std::unique_ptr<Node> plus;
    std::vector<SubEntry> here;  // filters ending exactly at this node
    std::vector<SubEntry> hash;  // filters ending in '#' one level below
    std::vector<SharedGroup> here_groups;
    std::vector<SharedGroup> hash_groups;
  };

  // Walk to the filter's terminal vectors; create the path on demand.
  // Returns (plain, groups) pointers via out-params; null when absent.
  template <bool Create>
  bool Terminal(const std::string& filter,
                std::vector<SharedGroup>** groups) {
    if (filter.find('+') == std::string::npos &&
        filter.find('#') == std::string::npos) {
      if (Create) {
        *groups = &exact_groups_[filter];
        return true;
      }
      auto it = exact_groups_.find(filter);
      if (it == exact_groups_.end()) return false;
      *groups = &it->second;
      return true;
    }
    SplitLevels(filter, &scratch_levels_);
    Node* n = &root_;
    for (size_t i = 0; i < scratch_levels_.size(); i++) {
      std::string_view w = scratch_levels_[i];
      if (w == "#") {
        *groups = &n->hash_groups;
        return true;
      }
      if (w == "+") {
        if (!n->plus) {
          if (!Create) return false;
          n->plus = std::make_unique<Node>();
        }
        n = n->plus.get();
      } else {
        auto it = n->kids.find(std::string(w));
        if (it == n->kids.end()) {
          if (!Create) return false;
          auto& kid = n->kids[std::string(w)];
          kid = std::make_unique<Node>();
          n = kid.get();
          continue;
        }
        n = it->second.get();
      }
    }
    *groups = &n->here_groups;
    return true;
  }

  SharedGroup* FindGroup(const std::string& filter, uint64_t token,
                         bool create) {
    std::vector<SharedGroup>* vec = nullptr;
    bool ok = create ? Terminal<true>(filter, &vec)
                     : Terminal<false>(filter, &vec);
    if (!ok || !vec) return nullptr;
    for (auto& g : *vec)
      if (g.token == token) return &g;
    if (!create) return nullptr;
    vec->push_back(SharedGroup{token, 0, {}});
    return &vec->back();
  }

  void DropGroup(const std::string& filter, uint64_t token) {
    std::vector<SharedGroup>* vec = nullptr;
    if (!Terminal<false>(filter, &vec) || !vec) return;
    for (size_t i = 0; i < vec->size(); i++) {
      if ((*vec)[i].token == token) {
        (*vec)[i] = std::move(vec->back());
        vec->pop_back();
        return;
      }
    }
  }

  // Returns true when a NEW entry was inserted (false = qos/flags
  // update in place) so callers can keep entry_count_ exact.
  static bool Upsert(std::vector<SubEntry>* v, uint64_t owner, uint8_t qos,
                     uint8_t flags) {
    for (auto& e : *v) {
      if (e.owner == owner) {
        e.qos = qos;
        e.flags = flags;
        return false;
      }
    }
    v->push_back(SubEntry{owner, qos, flags});
    return true;
  }

  static bool Erase(std::vector<SubEntry>* v, uint64_t owner) {
    for (size_t i = 0; i < v->size(); i++) {
      if ((*v)[i].owner == owner) {
        (*v)[i] = v->back();
        v->pop_back();
        return true;
      }
    }
    return false;
  }

  void MatchNode(Node* n, size_t i, std::vector<const SubEntry*>* out,
                 std::vector<SharedGroup*>* groups) {
    // "a/#" matches "a", "a/b", ... — the '#' list at node a covers the
    // remainder including zero further levels (emqx_trie 'match #')
    for (const auto& e : n->hash) out->push_back(&e);
    if (groups)
      for (auto& g : n->hash_groups) groups->push_back(&g);
    if (i == match_levels_.size()) {
      for (const auto& e : n->here) out->push_back(&e);
      if (groups)
        for (auto& g : n->here_groups) groups->push_back(&g);
      return;
    }
    // assign() reuses the scratch capacity: the per-message hot loop
    // must not heap-allocate per level just to query the kids map
    key_scratch_.assign(match_levels_[i].data(), match_levels_[i].size());
    auto it = n->kids.find(key_scratch_);
    if (it != n->kids.end()) MatchNode(it->second.get(), i + 1, out, groups);
    if (n->plus) MatchNode(n->plus.get(), i + 1, out, groups);
  }

  Node root_;
  size_t entry_count_ = 0;
  std::unordered_map<std::string, std::vector<SubEntry>> exact_;
  std::unordered_map<std::string, std::vector<SharedGroup>> exact_groups_;
  std::vector<std::string_view> scratch_levels_;
  std::vector<std::string_view> match_levels_;
  std::string key_scratch_;
};

// ---------------------------------------------------------------------------
// Host-side retained snapshot (round 11): the INVERSE trie problem —
// SubTable matches a topic NAME against stored FILTERS; this matches a
// subscription FILTER against stored topic NAMES, which is exactly the
// retainer's lookup (services/retainer.py, the Python oracle and the
// authoritative store). The Python server mirrors every retainer
// store/delete/expire into this table via poll-thread-applied ops (the
// match-table mutation discipline: swap-on-update serialized with
// matching), so SUBSCRIBE-triggered retained delivery resolves and
// writes below the GIL for TCP, WS, and SN subscribers alike.
//
// Threading: poll-thread-owned, like SubTable.

struct RetainEntry {
  std::string topic;
  std::string payload;
  uint8_t qos = 0;
  // absolute wall-clock expiry (ms since epoch, 0 = never): the
  // EFFECTIVE deadline — Python folds the per-message expiry property
  // and the store-wide default into one number at mirror time, so the
  // C++ check is a single compare
  uint64_t deadline_ms = 0;
  bool dollar = false;  // topic starts with '$' (root-wildcard guard)
};

class RetainTable {
 public:
  void Set(const std::string& topic, std::string_view payload, uint8_t qos,
           uint64_t deadline_ms) {
    SplitLevels(topic, &levels_);
    Node* n = &root_;
    for (std::string_view w : levels_) {
      auto& kid = n->kids[std::string(w)];
      if (!kid) kid = std::make_unique<Node>();
      n = kid.get();
    }
    if (!n->here) {
      n->here = std::make_unique<RetainEntry>();
      count_++;
    }
    n->here->topic = topic;
    n->here->payload.assign(payload.data(), payload.size());
    n->here->qos = qos;
    n->here->deadline_ms = deadline_ms;
    n->here->dollar = !topic.empty() && topic[0] == '$';
  }

  bool Del(const std::string& topic) {
    SplitLevels(topic, &levels_);
    Node* n = &root_;
    for (std::string_view w : levels_) {
      key_.assign(w.data(), w.size());
      auto it = n->kids.find(key_);
      if (it == n->kids.end()) return false;
      n = it->second.get();
    }
    if (!n->here) return false;
    n->here.reset();
    count_--;
    // interior nodes stay (the SubTable removal discipline: retained
    // churn re-creates them constantly, the footprint is tiny)
    return true;
  }

  // Every live (unexpired) retained topic matching `filter`, in trie
  // order. MQTT 4.7.2: a root-level wildcard never exposes '$'-topics.
  void Match(std::string_view filter, uint64_t now_ms,
             std::vector<const RetainEntry*>* out) {
    SplitLevels(filter, &match_levels_);
    bool guard = !match_levels_.empty() &&
                 (match_levels_[0] == "+" || match_levels_[0] == "#");
    MatchNode(&root_, 0, guard, now_ms, out);
  }

  size_t size() const { return count_; }

 private:
  struct Node {
    std::unordered_map<std::string, std::unique_ptr<Node>> kids;
    std::unique_ptr<RetainEntry> here;  // topic ending exactly here
  };

  void Emit(const Node* n, bool guard, uint64_t now_ms,
            std::vector<const RetainEntry*>* out) {
    const RetainEntry* e = n->here.get();
    if (!e) return;
    if (guard && e->dollar) return;
    if (e->deadline_ms && now_ms >= e->deadline_ms) return;  // expired:
    // skipped here, DELETED when the Python retainer's own lazy
    // expiry/sweep fires the delete observer
    out->push_back(e);
  }

  void Collect(const Node* n, bool guard, uint64_t now_ms,
               std::vector<const RetainEntry*>* out) {
    Emit(n, guard, now_ms, out);
    for (const auto& [w, kid] : n->kids)
      Collect(kid.get(), guard, now_ms, out);
  }

  void MatchNode(const Node* n, size_t i, bool guard, uint64_t now_ms,
                 std::vector<const RetainEntry*>* out) {
    if (i == match_levels_.size()) {
      Emit(n, guard, now_ms, out);
      return;
    }
    std::string_view w = match_levels_[i];
    if (w == "#") {
      // '#' covers the remainder INCLUDING zero further levels
      // ("a/#" matches "a") — emqx_topic.erl match semantics, same as
      // the retainer oracle's depth >= need mask
      Collect(n, guard, now_ms, out);
      return;
    }
    if (w == "+") {
      for (const auto& [word, kid] : n->kids) {
        if (i == 0 && !word.empty() && word[0] == '$') continue;
        MatchNode(kid.get(), i + 1, guard, now_ms, out);
      }
      return;
    }
    key_.assign(w.data(), w.size());
    auto it = n->kids.find(key_);
    if (it != n->kids.end()) MatchNode(it->second.get(), i + 1, guard,
                                       now_ms, out);
  }

  Node root_;
  size_t count_ = 0;
  std::vector<std::string_view> levels_;
  std::vector<std::string_view> match_levels_;
  std::string key_;
};

}  // namespace emqx_native
