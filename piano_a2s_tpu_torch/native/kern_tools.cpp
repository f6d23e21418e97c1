// kern_tools: native implementations of the humextra utilities the
// reference pipeline shells out to (reference: data_processing/render.py:73,
// 104, 153; datasets/asap.py:122,144; data_processing/humdrum.py:857):
//
//   kern_extract_spine  — extractx -s N   (extract one spine, tracks *^/*v)
//   kern_transpose      — transpose -t I  (diatonic transposition of notes,
//                                          key signatures, tonality markers)
//   kern_tiefix         — tiefix          (repair dangling ties)
//
// Exposed as a C ABI for ctypes (see piano_a2s_tpu/symbolic/native.py).
// Strings are malloc'd; callers free with kern_free.

#include <cctype>
#include <cstdlib>
#include <cstring>
#include <map>
#include <set>
#include <sstream>
#include <string>
#include <vector>

namespace {

std::vector<std::string> split_lines(const std::string& text) {
  std::vector<std::string> lines;
  std::string cur;
  for (char ch : text) {
    if (ch == '\n') {
      lines.push_back(cur);
      cur.clear();
    } else {
      cur.push_back(ch);
    }
  }
  if (!cur.empty()) lines.push_back(cur);
  return lines;
}

std::vector<std::string> split_tabs(const std::string& line) {
  std::vector<std::string> cols;
  std::string cur;
  for (char ch : line) {
    if (ch == '\t') {
      cols.push_back(cur);
      cur.clear();
    } else {
      cur.push_back(ch);
    }
  }
  cols.push_back(cur);
  return cols;
}

std::string join(const std::vector<std::string>& parts, char sep) {
  std::string out;
  for (size_t i = 0; i < parts.size(); ++i) {
    if (i) out.push_back(sep);
    out += parts[i];
  }
  return out;
}

char* dup_result(const std::string& s) {
  char* out = static_cast<char*>(std::malloc(s.size() + 1));
  if (out) std::memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

// ---------------------------------------------------------------------------
// Pitch arithmetic
// ---------------------------------------------------------------------------

const int kLetterSemis[7] = {0, 2, 4, 5, 7, 9, 11};  // C D E F G A B

struct Pitch {
  int letter;  // 0..6 == C..B
  int octave;  // scientific
  int alter;   // -2..2
};

// kern pitch spelling ("cc#", "BB-") -> Pitch; returns false if malformed.
bool parse_kern_pitch(const std::string& s, Pitch* p) {
  size_t i = 0;
  char base = s.empty() ? 0 : s[0];
  if (!std::isalpha(static_cast<unsigned char>(base))) return false;
  char upper = std::toupper(static_cast<unsigned char>(base));
  if (upper < 'A' || upper > 'G') return false;
  int count = 0;
  while (i < s.size() && s[i] == base) {
    ++count;
    ++i;
  }
  int alter = 0;
  while (i < s.size() && (s[i] == '#' || s[i] == '-')) {
    alter += (s[i] == '#') ? 1 : -1;
    ++i;
  }
  if (i != s.size()) return false;
  static const int kLetterIdx[7] = {5, 6, 0, 1, 2, 3, 4};  // A..G -> idx of C..B
  p->letter = kLetterIdx[upper - 'A'];
  p->octave = std::islower(static_cast<unsigned char>(base)) ? 3 + count
                                                             : 4 - count;
  p->alter = alter;
  return true;
}

std::string pitch_to_kern(const Pitch& p) {
  static const char kUpper[7] = {'C', 'D', 'E', 'F', 'G', 'A', 'B'};
  char letter = kUpper[p.letter];
  std::string out;
  if (p.octave >= 4) {
    int count = p.octave - 3;
    out.assign(count, std::tolower(letter));
  } else {
    int count = 4 - p.octave;
    out.assign(count, letter);
  }
  if (p.alter > 0) out.append(p.alter, '#');
  if (p.alter < 0) out.append(-p.alter, '-');
  return out;
}

struct Interval {
  int diatonic;   // letter steps
  int chromatic;  // semitones
  bool valid;
};

// "m2", "-M3", "P1", "0" -> interval.
Interval parse_interval(const std::string& s) {
  Interval iv{0, 0, true};
  if (s == "0" || s.empty()) return iv;
  size_t i = 0;
  int sign = 1;
  if (s[i] == '-') {
    sign = -1;
    ++i;
  } else if (s[i] == '+') {
    ++i;
  }
  if (i >= s.size()) {
    iv.valid = false;
    return iv;
  }
  char quality = s[i++];
  int number = 0;
  while (i < s.size() && std::isdigit(static_cast<unsigned char>(s[i]))) {
    number = number * 10 + (s[i] - '0');
    ++i;
  }
  if (number == 0 || i != s.size()) {
    iv.valid = false;
    return iv;
  }
  int d = number - 1;
  // Semitone spans of major/perfect simple intervals C..octave.
  static const int kMajor[8] = {0, 2, 4, 5, 7, 9, 11, 12};
  int base = kMajor[d % 7] + 12 * (d / 7);
  int c;
  switch (quality) {
    case 'P': c = base; break;
    case 'M': c = base; break;
    case 'm': c = base - 1; break;
    case 'A': c = base + 1; break;
    case 'd': c = base - ((d % 7 == 0 || d % 7 == 3 || d % 7 == 4) ? 1 : 2);
              break;
    default: iv.valid = false; return iv;
  }
  iv.diatonic = sign * d;
  iv.chromatic = sign * c;
  return iv;
}

Pitch transpose_pitch(const Pitch& p, const Interval& iv) {
  int diat = p.octave * 7 + p.letter + iv.diatonic;
  int new_oct = diat >= 0 ? diat / 7 : (diat - 6) / 7;
  int new_letter = diat - new_oct * 7;
  int chroma = p.octave * 12 + kLetterSemis[p.letter] + p.alter
               + iv.chromatic;
  Pitch out;
  out.letter = new_letter;
  out.octave = new_oct;
  out.alter = chroma - (new_oct * 12 + kLetterSemis[new_letter]);
  return out;
}

int interval_fifths_delta(const Interval& iv) {
  return 7 * iv.chromatic - 12 * iv.diatonic;
}

// ---------------------------------------------------------------------------
// Spine tracking (for extract)
// ---------------------------------------------------------------------------

struct SpineTracker {
  // Each column carries its ROOT spine (header spine it descends from —
  // used by extraction and type checks) and a BRANCH id (unique per split
  // branch — used by tie chains so sibling unison ties never interleave).
  std::vector<std::pair<int, int>> cols;  // (root, branch) per column
  std::map<int, std::string> spine_type;  // root id -> interpretation
  int next_id = 1;                        // fresh branch ids
  bool started = false;

  void init(const std::vector<std::string>& header_cols) {
    cols.clear();
    spine_type.clear();
    for (size_t i = 0; i < header_cols.size(); ++i) {
      int id = static_cast<int>(i) + 1;
      cols.push_back({id, id});
      spine_type[id] = header_cols[i];
    }
    next_id = static_cast<int>(header_cols.size()) + 1;
    started = true;
  }

  int root(size_t ci) const {
    if (!started) return static_cast<int>(ci) + 1;
    return ci < cols.size() ? cols[ci].first : 0;
  }

  int spine(size_t ci) const {  // branch identity
    if (!started) return static_cast<int>(ci) + 1;
    return ci < cols.size() ? cols[ci].second : 0;
  }

  bool is_kern(size_t ci) const {
    if (!started) return true;  // bare fragments default to kern
    auto it = spine_type.find(root(ci));
    return it != spine_type.end() &&
           it->second.rfind("**kern", 0) == 0;
  }

  // Apply a *^/*v manipulation line. false on unsupported *+ / *x.
  bool apply(const std::vector<std::string>& items) {
    for (const auto& c : items)
      if (c == "*+" || c == "*x") return false;
    if (!started) return true;
    std::vector<std::pair<int, int>> next;
    bool in_merge_run = false;
    for (size_t i = 0; i < items.size(); ++i) {
      std::pair<int, int> pair =
          i < cols.size() ? cols[i] : std::make_pair(0, 0);
      if (items[i] == "*v") {
        if (!in_merge_run) next.push_back(pair);  // merged: first ids
        in_merge_run = true;
        continue;
      }
      in_merge_run = false;
      if (items[i] == "*^") {
        // First branch keeps the parent branch id (ties may span the
        // split); the second gets a fresh branch id.
        next.push_back(pair);
        next.push_back({pair.first, next_id});
        ++next_id;
      } else {
        next.push_back(pair);
      }
    }
    cols = next;
    return true;
  }
};

bool is_manip(const std::vector<std::string>& cols) {
  for (const auto& c : cols)
    if (c == "*^" || c == "*v" || c == "*+" || c == "*x") return true;
  return false;
}

}  // namespace

extern "C" {

void kern_free(char* p) { std::free(p); }

// extractx -s N equivalent: keep columns of 1-based spine N, following
// spine splits/merges. Global (!!) lines pass through. Returns nullptr on
// unsupported *+ / *x manipulators (column identities would be wrong).
char* kern_extract_spine(const char* data, int spine) {
  std::vector<std::string> lines = split_lines(data ? data : "");
  SpineTracker tracker;
  std::ostringstream out;
  for (const auto& line : lines) {
    if (line.rfind("!!", 0) == 0 || line.empty()) {
      out << line << '\n';
      continue;
    }
    std::vector<std::string> cols = split_tabs(line);
    if (!tracker.started && line.rfind("**", 0) == 0) {
      tracker.init(cols);
    }
    std::vector<std::string> kept;
    for (size_t i = 0; i < cols.size() && i < tracker.cols.size(); ++i) {
      if (tracker.root(i) == spine) kept.push_back(cols[i]);
    }
    if (tracker.started && is_manip(cols)) {
      // Emit manipulators only if they affect the kept spine.
      bool any = false;
      for (const auto& k : kept)
        if (k == "*^" || k == "*v") any = true;
      if (any && !kept.empty()) {
        // A lone *v merge line collapses to nothing meaningful when only
        // one column remains; keep pairs, drop singletons of *v.
        if (!(kept.size() == 1 && kept[0] == "*v")) out << join(kept, '\t')
                                                        << '\n';
      }
      if (!tracker.apply(cols)) return nullptr;
      continue;
    }
    if (!kept.empty()) out << join(kept, '\t') << '\n';
  }
  return dup_result(out.str());
}

// transpose -t I equivalent: diatonic transposition of notes, key
// signatures (*k[...]) and tonality markers (*X:). interval examples:
// "m2", "-M3", "P1", "0".
char* kern_transpose(const char* data, const char* interval_str) {
  Interval iv = parse_interval(interval_str ? interval_str : "0");
  if (!iv.valid) return nullptr;
  std::vector<std::string> lines = split_lines(data ? data : "");
  std::ostringstream out;
  int fifths_delta = interval_fifths_delta(iv);
  SpineTracker tracker;

  for (const auto& line : lines) {
    if (line.rfind("**", 0) == 0) {
      if (!tracker.started) tracker.init(split_tabs(line));
      out << line << '\n';
      continue;
    }
    if (line.rfind("!", 0) == 0 || line.rfind("=", 0) == 0) {
      out << line << '\n';
      continue;
    }
    std::vector<std::string> cols = split_tabs(line);
    if (line.rfind("*", 0) == 0 && is_manip(cols)) {
      tracker.apply(cols);  // *+/*x columns pass through untouched
      out << line << '\n';
      continue;
    }
    std::vector<std::string> newcols;
    for (size_t ci = 0; ci < cols.size(); ++ci) {
      auto& col = cols[ci];
      if (!tracker.is_kern(ci)) {
        newcols.push_back(col);  // never transpose non-**kern spines
        continue;
      }
      if (col.rfind("*k[", 0) == 0) {
        // Count sharps(+)/flats(-) -> fifths; shift; regenerate.
        int sharps = 0, flats = 0;
        for (char ch : col) {
          if (ch == '#') ++sharps;
          if (ch == '-') ++flats;
        }
        int fifths = sharps ? sharps : -flats;
        fifths += fifths_delta;
        while (fifths > 7) fifths -= 12;
        while (fifths < -7) fifths += 12;
        static const char* kSharpOrder[7] = {"f#", "c#", "g#", "d#",
                                             "a#", "e#", "b#"};
        static const char* kFlatOrder[7] = {"b-", "e-", "a-", "d-",
                                            "g-", "c-", "f-"};
        std::string sig = "*k[";
        for (int i = 0; i < (fifths > 0 ? fifths : -fifths) && i < 7; ++i)
          sig += (fifths > 0 ? kSharpOrder[i] : kFlatOrder[i]);
        sig += "]";
        newcols.push_back(sig);
        continue;
      }
      if (col.size() >= 2 && col[0] == '*' && col.back() == ':') {
        // Tonality marker *G: / *e-: — transpose the tonic letter. The
        // letter case encodes MODE (major/minor): preserve the input's
        // case, never derive it from the computed octave.
        Pitch p;
        std::string tonic = col.substr(1, col.size() - 2);
        if (parse_kern_pitch(tonic, &p) && !tonic.empty()) {
          Pitch np = transpose_pitch(p, iv);
          static const char kUpperL[7] = {'C', 'D', 'E', 'F', 'G', 'A',
                                          'B'};
          char letter = kUpperL[np.letter];
          if (std::islower(static_cast<unsigned char>(tonic[0])))
            letter = std::tolower(letter);
          std::string accs;
          if (np.alter > 0) accs.assign(np.alter, '#');
          if (np.alter < 0) accs.assign(-np.alter, '-');
          newcols.push_back(std::string("*") + letter + accs + ":");
          continue;
        }
        newcols.push_back(col);
        continue;
      }
      if (col.rfind("*", 0) == 0 || col == ".") {
        newcols.push_back(col);
        continue;
      }
      // Data token: transpose each pitched note in the chord.
      std::vector<std::string> notes;
      {
        std::string cur;
        for (char ch : col) {
          if (ch == ' ') {
            notes.push_back(cur);
            cur.clear();
          } else {
            cur.push_back(ch);
          }
        }
        notes.push_back(cur);
      }
      std::vector<std::string> newnotes;
      for (const auto& note : notes) {
        // Locate the pitch substring: run of letters a-gA-G + accidentals.
        size_t start = std::string::npos, end = std::string::npos;
        for (size_t i = 0; i < note.size(); ++i) {
          char ch = note[i];
          char lo = std::tolower(static_cast<unsigned char>(ch));
          if (lo >= 'a' && lo <= 'g') {
            start = i;
            end = i + 1;
            while (end < note.size() && note[end] == ch) ++end;
            while (end < note.size() &&
                   (note[end] == '#' || note[end] == '-'))
              ++end;
            break;
          }
          if (lo == 'r') break;  // rest
        }
        if (start == std::string::npos) {
          newnotes.push_back(note);
          continue;
        }
        Pitch p;
        if (!parse_kern_pitch(note.substr(start, end - start), &p)) {
          newnotes.push_back(note);
          continue;
        }
        Pitch np = transpose_pitch(p, iv);
        newnotes.push_back(note.substr(0, start) + pitch_to_kern(np) +
                           note.substr(end));
      }
      newcols.push_back(join(newnotes, ' '));
    }
    out << join(newcols, '\t') << '\n';
  }
  return dup_result(out.str());
}

// tiefix equivalent: strip tie continues/closes with no matching open at
// the same pitch in the same spine, and opens never consumed.
char* kern_tiefix(const char* data) {
  std::vector<std::string> lines = split_lines(data ? data : "");
  // Pass 1: locate notes per (column, pitch-string) in order.
  struct Ref {
    size_t line, col, note;
    bool open, cont, close;
  };
  std::map<std::pair<int, std::string>, std::vector<Ref>> chains;
  std::vector<std::vector<std::vector<std::string>>> parsed(lines.size());
  SpineTracker tracker;
  for (size_t li = 0; li < lines.size(); ++li) {
    const std::string& line = lines[li];
    if (line.rfind("**", 0) == 0 && !tracker.started) {
      tracker.init(split_tabs(line));
      continue;
    }
    if (!line.empty() && line[0] == '*') {
      std::vector<std::string> items = split_tabs(line);
      if (is_manip(items)) tracker.apply(items);
      continue;
    }
    if (line.empty() || line[0] == '!' || line[0] == '=')
      continue;
    std::vector<std::string> cols = split_tabs(line);
    parsed[li].resize(cols.size());
    for (size_t ci = 0; ci < cols.size(); ++ci) {
      std::string cur;
      std::vector<std::string> notes;
      for (char ch : cols[ci]) {
        if (ch == ' ') {
          notes.push_back(cur);
          cur.clear();
        } else
          cur.push_back(ch);
      }
      notes.push_back(cur);
      parsed[li][ci] = notes;
      for (size_t ni = 0; ni < notes.size(); ++ni) {
        const std::string& n = notes[ni];
        if (n.empty() || n == ".") continue;
        bool open = n[0] == '[';
        bool cont = n.find('_') != std::string::npos;
        bool close = n.find(']') != std::string::npos;
        if (!open && !cont && !close) continue;
        // pitch substring
        size_t start = std::string::npos, end = 0;
        for (size_t i = 0; i < n.size(); ++i) {
          char lo = std::tolower(static_cast<unsigned char>(n[i]));
          if (lo >= 'a' && lo <= 'g') {
            start = i;
            end = i + 1;
            while (end < n.size() && n[end] == n[i]) ++end;
            while (end < n.size() && (n[end] == '#' || n[end] == '-')) ++end;
            break;
          }
          if (lo == 'r') break;
        }
        if (start == std::string::npos) continue;
        // Chains follow SPINES (stable across *^/*v), not raw columns.
        chains[{tracker.spine(ci), n.substr(start, end - start)}].push_back(
            {li, ci, ni, open, cont, close});
      }
    }
  }
  // Pass 2: decide repairs.
  std::set<std::tuple<size_t, size_t, size_t, char>> strip;  // (l,c,n,flag)
  for (auto& kv : chains) {
    auto& refs = kv.second;
    bool open_tie = false;
    for (size_t j = 0; j < refs.size(); ++j) {
      Ref& r = refs[j];
      bool cont = r.cont, close = r.close;
      if ((cont || close) && !open_tie) {
        if (cont) strip.insert({r.line, r.col, r.note, '_'});
        if (close) strip.insert({r.line, r.col, r.note, ']'});
        cont = close = false;
      }
      if (close) open_tie = false;
      if (r.open || cont) {
        bool consumed = (j + 1 < refs.size()) &&
                        (refs[j + 1].cont || refs[j + 1].close);
        if (consumed) {
          open_tie = true;
        } else {
          if (cont) {
            // dangling continue becomes a close: replace _ with ]
            strip.insert({r.line, r.col, r.note, '>'});
          } else if (r.open) {
            strip.insert({r.line, r.col, r.note, '['});
          }
          open_tie = false;
        }
      }
    }
  }
  // Pass 3: rewrite.
  std::ostringstream out;
  for (size_t li = 0; li < lines.size(); ++li) {
    const std::string& line = lines[li];
    if (parsed[li].empty()) {
      out << line << '\n';
      continue;
    }
    std::vector<std::string> cols;
    for (size_t ci = 0; ci < parsed[li].size(); ++ci) {
      std::vector<std::string> notes = parsed[li][ci];
      for (size_t ni = 0; ni < notes.size(); ++ni) {
        std::string n = notes[ni];
        auto has = [&](char f) {
          return strip.count({li, ci, ni, f}) > 0;
        };
        if (has('[')) {
          size_t pos = n.find('[');
          if (pos != std::string::npos) n.erase(pos, 1);
        }
        if (has('_')) {
          size_t pos = n.find('_');
          if (pos != std::string::npos) n.erase(pos, 1);
        }
        if (has(']')) {
          size_t pos = n.find(']');
          if (pos != std::string::npos) n.erase(pos, 1);
        }
        if (has('>')) {  // dangling '_' ends the tie instead
          size_t pos = n.find('_');
          if (pos != std::string::npos) n[pos] = ']';
        }
        notes[ni] = n;
      }
      cols.push_back(join(notes, ' '));
    }
    out << join(cols, '\t') << '\n';
  }
  return dup_result(out.str());
}

}  // extern "C"
