// Native bAbI parser/vectorizer.
//
// The reference's data pipeline is C (MemN2N/sample.c, 957 LoC):
// sample_constructor parses the custom '+NS+' format, dictionary_constructor
// builds a case-insensitive vocabulary, sample_vectorization produces
// bag-of-words vectors with temporal encoding.  This is the same pipeline,
// re-designed (not translated) in C++ for the framework's host side:
// both the parsed and the raw bAbI formats, one pass, flat padded output
// arrays ready for device upload.  Exposed via a C ABI consumed through
// ctypes (qmann_tpu/data/native.py); the Python implementation in
// qmann_tpu/data/babi.py is the behavioral reference and fallback.
//
// Build: make -C native   (produces libqmann_data.so)

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Sample {
  std::vector<std::vector<std::string>> sentences;
  std::vector<std::string> question;
  std::vector<std::string> answer;
};

std::string lower(const std::string& s) {
  std::string out(s);
  std::transform(out.begin(), out.end(), out.begin(),
                 [](unsigned char c) { return std::tolower(c); });
  return out;
}

std::vector<std::string> split_ws(const std::string& line) {
  std::vector<std::string> out;
  std::istringstream iss(line);
  std::string w;
  while (iss >> w) out.push_back(w);
  return out;
}

// parser.py-style tokenization: split on non-word characters, keeping
// punctuation runs as their own tokens.
std::vector<std::string> tokenize(const std::string& s) {
  std::vector<std::string> out;
  std::string cur;
  auto flush = [&]() {
    if (!cur.empty()) { out.push_back(cur); cur.clear(); }
  };
  bool in_word = false;
  for (char c : s) {
    bool word_char = std::isalnum(static_cast<unsigned char>(c)) || c == '_';
    if (word_char != in_word) { flush(); in_word = word_char; }
    if (word_char) {
      cur.push_back(c);
    } else if (!std::isspace(static_cast<unsigned char>(c))) {
      cur.push_back(c);
    } else {
      flush();
    }
  }
  flush();
  return out;
}

// strtol-style tolerant parse: returns fallback on malformed input so
// corrupt data files degrade to empty/short datasets instead of throwing
// (exceptions must never cross the extern "C" ABI into ctypes).
long parse_long(const std::string& s, long fallback = -1) {
  try {
    size_t pos = 0;
    long v = std::stol(s, &pos);
    return pos == 0 ? fallback : v;
  } catch (...) {
    return fallback;
  }
}

std::string strip(const std::string& s) {
  size_t b = s.find_first_not_of(" \t\r\n");
  if (b == std::string::npos) return "";
  size_t e = s.find_last_not_of(" \t\r\n");
  return s.substr(b, e - b + 1);
}

// '+NS+' custom format (MemN2N/sample.c:87-249 semantics).
std::vector<Sample> parse_parsed(const std::string& path, int max_sen_len,
                                 int limit) {
  std::ifstream f(path);
  if (!f) return {};
  std::vector<std::string> lines;
  std::string line;
  while (std::getline(f, line)) lines.push_back(line);

  size_t i = 0;
  while (i < lines.size() && strip(lines[i]) != "+NS+") i++;
  if (i + 1 >= lines.size()) return {};
  long n_samples = parse_long(strip(lines[i + 1]), 0);
  if (limit >= 0 && limit < n_samples) n_samples = limit;
  i += 2;

  std::vector<Sample> samples;
  while ((long)samples.size() < n_samples && i < lines.size()) {
    while (i < lines.size() && strip(lines[i]) != "+I+") i++;
    if (i >= lines.size()) break;
    i += 2;  // +I+, index
    if (i + 1 >= lines.size() || strip(lines[i]) != "+S+") break;
    long n_sen_l = parse_long(strip(lines[i + 1]), -1);
    if (n_sen_l < 0) break;
    int n_sen = (int)n_sen_l;
    i += 2;
    Sample s;
    for (int k = 0; k < n_sen && i < lines.size(); k++, i++) {
      s.sentences.push_back(split_ws(lines[i]));
    }
    if (n_sen > max_sen_len) {
      s.sentences.erase(s.sentences.begin(),
                        s.sentences.begin() + (n_sen - max_sen_len));
    }
    if (i + 1 >= lines.size() || strip(lines[i]) != "+Q+") break;
    s.question = split_ws(lines[i + 1]);
    i += 2;
    if (i + 1 >= lines.size() || strip(lines[i]) != "+A+") break;
    s.answer = split_ws(lines[i + 1]);
    i += 2;
    samples.push_back(std::move(s));
  }
  return samples;
}

// Raw bAbI task text.
std::vector<Sample> parse_raw(const std::string& path, int max_sen_len,
                              int limit) {
  std::ifstream f(path);
  if (!f) return {};
  std::vector<Sample> samples;
  std::vector<std::vector<std::string>> story;
  std::string raw;
  while (std::getline(f, raw)) {
    std::string line = strip(raw);
    if (line.empty()) continue;
    size_t sp = line.find(' ');
    if (sp == std::string::npos) continue;
    long nid = parse_long(line.substr(0, sp), -1);
    if (nid < 0) continue;  // malformed line id: skip
    std::string rest = line.substr(sp + 1);
    if (nid == 1) story.clear();
    size_t tab = rest.find('\t');
    if (tab != std::string::npos) {
      std::string q = rest.substr(0, tab);
      std::string remainder = rest.substr(tab + 1);
      size_t tab2 = remainder.find('\t');
      std::string a = tab2 == std::string::npos ? remainder
                                                : remainder.substr(0, tab2);
      Sample s;
      auto q_tokens = tokenize(q);
      if (!q_tokens.empty()) q_tokens.pop_back();  // drop trailing '?'
      s.question = q_tokens;
      s.answer = {strip(a)};
      for (auto& sent : story)
        if (!sent.empty()) s.sentences.push_back(sent);
      if ((int)s.sentences.size() > max_sen_len) {
        s.sentences.erase(s.sentences.begin(),
                          s.sentences.begin() +
                              (s.sentences.size() - max_sen_len));
      }
      story.push_back({});
      samples.push_back(std::move(s));
      if (limit >= 0 && (long)samples.size() >= limit) break;
    } else {
      auto tokens = tokenize(rest);
      if (!tokens.empty() && tokens.back() == ".") tokens.pop_back();
      story.push_back(tokens);
    }
  }
  return samples;
}

struct Dataset {
  std::vector<Sample> train, test;
  std::vector<std::string> dict_words;      // insertion order; [0] = NULL
  std::unordered_map<std::string, int> dict_index;  // lowercased -> idx
  int dim_dict = 0, max_line = 0, max_word = 0, dim_word = 0, dim_input = 0;
  bool enable_time = true;

  int lookup(const std::string& w) const {
    auto it = dict_index.find(lower(w));
    return it == dict_index.end() ? -1 : it->second;
  }

  void add_word(const std::string& w) {
    std::string key = lower(w);
    if (dict_index.count(key)) return;
    dict_index.emplace(key, (int)dict_words.size());
    dict_words.push_back(w);
  }

  void build(bool en_time, int pad_dict, int pad_line) {
    enable_time = en_time;
    add_word("NULL");  // index 0 (sample.c:856-859)
    for (const auto& s : train) {           // scan order per sample.c:860-929
      for (const auto& sent : s.sentences)
        for (const auto& w : sent) add_word(w);
      for (const auto& w : s.question) add_word(w);
      for (const auto& w : s.answer) add_word(w);
    }
    for (const auto& s : train) {
      max_line = std::max(max_line, (int)s.sentences.size());
      for (const auto& sent : s.sentences)
        max_word = std::max(max_word, (int)sent.size());
    }
    // optional uniform-layout padding (the DIM_FORCED idea,
    // MemN2N/define.h:151: fixed dims so one compiled program serves
    // every task); vocabulary indices stay < the actual dict size
    dim_dict = std::max((int)dict_words.size(), pad_dict);
    max_line = std::max(max_line, pad_line);
    dim_input = enable_time ? dim_dict + max_line : dim_dict;
    dim_word = enable_time ? max_word + 1 : max_word;
  }

  // sample_vectorization semantics (MemN2N/sample.c:413-574)
  void fill(const std::vector<Sample>& split, float* memory, float* question,
            float* answer, int32_t* n_sen, int32_t* answer_index) const {
    const size_t row = (size_t)dim_input;
    const size_t mem_stride = (size_t)max_line * row;
    std::memset(memory, 0, split.size() * mem_stride * sizeof(float));
    std::memset(question, 0, split.size() * row * sizeof(float));
    std::memset(answer, 0, split.size() * row * sizeof(float));
    for (size_t si = 0; si < split.size(); si++) {
      const Sample& s = split[si];
      // test/valid stories can exceed the train-derived max_line; the
      // reference truncates every split to it keeping the MOST RECENT
      // sentences (sample_constructor(&path_test, max_line, ...),
      // MemN2N/MemN2N.c:585)
      int total = (int)s.sentences.size();
      int drop = total > max_line ? total - max_line : 0;
      int ns = total - drop;
      n_sen[si] = ns;
      float* mem = memory + si * mem_stride;
      for (int j = 0; j < ns; j++) {
        const auto& sent = s.sentences[drop + j];
        int keep = enable_time ? std::min((int)sent.size(), dim_word - 1)
                               : std::min((int)sent.size(), dim_word);
        for (int k = 0; k < keep; k++) {
          int idx = lookup(sent[k]);
          if (idx >= 0) mem[j * row + idx] += 1.0f;
        }
        if (enable_time) {
          int te = dim_dict + ns - j - 1;  // sample.c:474
          if (te < dim_input) mem[j * row + te] = 1.0f;
        }
      }
      int nq = enable_time ? std::min((int)s.question.size(), dim_word - 1)
                           : std::min((int)s.question.size(), dim_word);
      for (int k = 0; k < nq; k++) {
        int idx = lookup(s.question[k]);
        if (idx >= 0) question[si * row + idx] += 1.0f;
      }
      int na = enable_time ? std::min((int)s.answer.size(), dim_word - 1)
                           : std::min((int)s.answer.size(), dim_word);
      answer_index[si] = 0;
      bool first = true;
      for (int k = 0; k < na; k++) {
        int idx = lookup(s.answer[k]);
        if (idx >= 0) {
          answer[si * row + idx] += 1.0f;
          if (first) { answer_index[si] = idx; first = false; }
        }
      }
    }
  }
};

}  // namespace

extern "C" {

void* qm_load(const char* train_path, int train_is_raw, const char* test_path,
              int test_is_raw, int max_sen_len, int enable_time,
              int limit_train, int limit_test, int pad_dict, int pad_line) {
  // never let a C++ exception unwind across the C ABI into ctypes
  try {
    auto* d = new Dataset();
    d->train = train_is_raw
                   ? parse_raw(train_path, max_sen_len, limit_train)
                   : parse_parsed(train_path, max_sen_len, limit_train);
    d->test = test_is_raw ? parse_raw(test_path, max_sen_len, limit_test)
                          : parse_parsed(test_path, max_sen_len, limit_test);
    if (d->train.empty() && d->test.empty()) {
      delete d;
      return nullptr;
    }
    d->build(enable_time != 0, pad_dict, pad_line);
    return d;
  } catch (...) {
    return nullptr;
  }
}

void qm_free(void* h) { delete static_cast<Dataset*>(h); }

int qm_dim_dict(void* h) { return static_cast<Dataset*>(h)->dim_dict; }
int qm_max_line(void* h) { return static_cast<Dataset*>(h)->max_line; }
int qm_max_word(void* h) { return static_cast<Dataset*>(h)->max_word; }
int qm_dim_word(void* h) { return static_cast<Dataset*>(h)->dim_word; }
int qm_dim_input(void* h) { return static_cast<Dataset*>(h)->dim_input; }
int qm_num_train(void* h) {
  return (int)static_cast<Dataset*>(h)->train.size();
}
int qm_num_test(void* h) {
  return (int)static_cast<Dataset*>(h)->test.size();
}
int qm_dict_size(void* h) {
  return (int)static_cast<Dataset*>(h)->dict_words.size();
}
const char* qm_dict_word(void* h, int i) {
  auto* d = static_cast<Dataset*>(h);
  if (i < 0 || i >= (int)d->dict_words.size()) return "";
  return d->dict_words[i].c_str();
}

// split: 0 = train, 1 = test.  Buffers sized by the caller from the dims.
void qm_fill(void* h, int split, float* memory, float* question,
             float* answer, int32_t* n_sen, int32_t* answer_index) {
  auto* d = static_cast<Dataset*>(h);
  d->fill(split == 0 ? d->train : d->test, memory, question, answer, n_sen,
          answer_index);
}

}  // extern "C"
