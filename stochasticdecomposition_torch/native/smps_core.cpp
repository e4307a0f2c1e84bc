// Native SMPS core-file (MPS) parser.
//
// The reference delegates SMPS ingestion to the spAlgorithms C library
// (readCore, used at twoSD.c:259).  This is the TPU framework's native
// equivalent: a single-pass tokenizer that turns an MPS core file into flat
// arrays (COO matrix triplets, rhs, senses, bounds, objective) consumed via
// ctypes by stochasticdecomposition_tpu/smps/native.py.  Large instances
// (storm-class, ~100k nonzeros) parse in milliseconds.
//
// C ABI: sd_parse_core() returns an opaque handle; getters expose sizes and
// buffer pointers; sd_free_core() releases it.  Thread-safe (no globals).

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <map>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct CoreData {
    std::string name;
    std::string objname;
    std::string error;
    // Rows (constraints only; objective excluded).
    std::vector<std::string> row_names;
    std::vector<int8_t> sense;              // -1 '<=', 0 '=', +1 '>='
    std::vector<double> rhs;
    // Columns.
    std::vector<std::string> col_names;
    std::vector<double> obj;
    std::vector<double> lb;
    std::vector<double> ub;
    std::vector<uint8_t> is_int;
    // Matrix COO.
    std::vector<int32_t> mat_row;
    std::vector<int32_t> mat_col;
    std::vector<double> mat_val;
    double obj_constant = 0.0;
    // RANGES rows reformulated to equality + bounded slack column
    // (parallel arrays: constraint row index, appended slack column index).
    std::vector<int32_t> range_rows;
    std::vector<int32_t> range_cols;
    // Flattened name blobs for the Python side.
    std::string row_blob;                   // '\n'-joined
    std::string col_blob;
};

const double kInf = std::numeric_limits<double>::infinity();

struct Tok {
    const char* p;
    size_t len;
    std::string str() const { return std::string(p, len); }
};

// Split a line into whitespace-delimited tokens; '$'/'*' start comments.
int tokenize(char* line, Tok* toks, int max_toks) {
    int n = 0;
    char* s = line;
    while (*s && n < max_toks) {
        while (*s == ' ' || *s == '\t' || *s == '\r' || *s == '\n') ++s;
        if (!*s || *s == '$' || *s == '*') break;
        const char* start = s;
        while (*s && *s != ' ' && *s != '\t' && *s != '\r' && *s != '\n') ++s;
        toks[n].p = start;
        toks[n].len = static_cast<size_t>(s - start);
        ++n;
    }
    return n;
}

bool token_eq(const Tok& t, const char* u) {
    size_t ul = strlen(u);
    if (t.len != ul) return false;
    for (size_t i = 0; i < ul; ++i)
        if (toupper(t.p[i]) != u[i]) return false;
    return true;
}

}  // namespace

extern "C" {

void* sd_parse_core(const char* path) {
    auto* cd = new CoreData();
    FILE* fh = fopen(path, "rb");
    if (!fh) {
        cd->error = "cannot open file";
        return cd;
    }

    enum Section { NONE, ROWS, COLUMNS, RHS, RANGES, BOUNDS, OBJSENSE } sec = NONE;
    std::unordered_map<std::string, int32_t> row_index;
    std::unordered_map<std::string, int32_t> col_index;
    std::map<int32_t, double> range_vals;   // ordered: ascending row index
    bool have_obj = false;
    bool in_integer = false;
    int objsense = 1;

    char line[8192];
    Tok toks[16];
    while (fgets(line, sizeof(line), fh)) {
        if (line[0] != ' ' && line[0] != '\t') {
            int nt = tokenize(line, toks, 16);
            if (nt == 0) continue;
            if (token_eq(toks[0], "NAME")) {
                if (nt > 1) cd->name = toks[1].str();
                sec = NONE;
            } else if (token_eq(toks[0], "OBJSENSE")) {
                sec = OBJSENSE;
            } else if (token_eq(toks[0], "ROWS")) {
                sec = ROWS;
            } else if (token_eq(toks[0], "COLUMNS")) {
                sec = COLUMNS;
            } else if (token_eq(toks[0], "RHS")) {
                sec = RHS;
            } else if (token_eq(toks[0], "RANGES")) {
                sec = RANGES;
            } else if (token_eq(toks[0], "BOUNDS")) {
                sec = BOUNDS;
            } else if (token_eq(toks[0], "ENDATA")) {
                break;
            } else {
                cd->error = "unknown MPS section: " + toks[0].str();
                break;
            }
            continue;
        }
        int nt = tokenize(line, toks, 16);
        if (nt == 0) continue;

        switch (sec) {
            case OBJSENSE: {
                if (toks[0].len >= 3 && toupper(toks[0].p[0]) == 'M' &&
                    toupper(toks[0].p[1]) == 'A') objsense = -1;
                break;
            }
            case ROWS: {
                char t = static_cast<char>(toupper(toks[0].p[0]));
                std::string rname = toks[1].str();
                if (t == 'N') {
                    if (!have_obj) {
                        cd->objname = rname;
                        have_obj = true;
                    }
                } else {
                    int8_t s = (t == 'L') ? -1 : (t == 'G') ? 1 : 0;
                    row_index.emplace(rname, (int32_t)cd->row_names.size());
                    cd->row_names.push_back(rname);
                    cd->sense.push_back(s);
                    cd->rhs.push_back(0.0);
                }
                break;
            }
            case COLUMNS: {
                if (nt >= 3 && token_eq(toks[1], "'MARKER'")) {
                    if (token_eq(toks[2], "'INTORG'")) in_integer = true;
                    else if (token_eq(toks[2], "'INTEND'")) in_integer = false;
                    break;
                }
                std::string cname = toks[0].str();
                auto it = col_index.find(cname);
                int32_t j;
                if (it == col_index.end()) {
                    j = (int32_t)cd->col_names.size();
                    col_index.emplace(cname, j);
                    cd->col_names.push_back(cname);
                    cd->obj.push_back(0.0);
                    cd->lb.push_back(0.0);
                    cd->ub.push_back(kInf);
                    cd->is_int.push_back(in_integer ? 1 : 0);
                } else {
                    j = it->second;
                }
                for (int k = 1; k + 1 < nt; k += 2) {
                    std::string rname = toks[k].str();
                    double val = strtod(toks[k + 1].p, nullptr);
                    if (have_obj && rname == cd->objname) {
                        cd->obj[j] += val;
                    } else {
                        auto rit = row_index.find(rname);
                        if (rit == row_index.end()) {
                            cd->error = "COLUMNS references unknown row " + rname;
                            fclose(fh);
                            return cd;
                        }
                        cd->mat_row.push_back(rit->second);
                        cd->mat_col.push_back(j);
                        cd->mat_val.push_back(val);
                    }
                }
                break;
            }
            case RHS: {
                int start = (nt % 2 == 1) ? 1 : 0;
                for (int k = start; k + 1 < nt; k += 2) {
                    std::string rname = toks[k].str();
                    double val = strtod(toks[k + 1].p, nullptr);
                    if (have_obj && rname == cd->objname) {
                        cd->obj_constant = -val;
                    } else {
                        auto rit = row_index.find(rname);
                        if (rit == row_index.end()) {
                            cd->error = "RHS references unknown row " + rname;
                            fclose(fh);
                            return cd;
                        }
                        cd->rhs[rit->second] = val;
                    }
                }
                break;
            }
            case RANGES: {
                int start = (nt % 2 == 1) ? 1 : 0;
                for (int k = start; k + 1 < nt; k += 2) {
                    std::string rname = toks[k].str();
                    double val = strtod(toks[k + 1].p, nullptr);
                    auto rit = row_index.find(rname);
                    if (rit == row_index.end()) {
                        cd->error = "RANGES references unknown row " + rname;
                        fclose(fh);
                        return cd;
                    }
                    range_vals[rit->second] = val;
                }
                break;
            }
            case BOUNDS: {
                // '<type> [<setname>] <col> [<val>]'
                std::string btype;
                for (size_t i = 0; i < toks[0].len; ++i)
                    btype += static_cast<char>(toupper(toks[0].p[i]));
                bool no_val = (btype == "FR" || btype == "MI" ||
                               btype == "PL" || btype == "BV");
                std::string cname;
                double val = 0.0;
                if (no_val) {
                    // column is the last token that names a column
                    for (int k = nt - 1; k >= 1; --k) {
                        if (col_index.count(toks[k].str())) {
                            cname = toks[k].str();
                            break;
                        }
                    }
                } else if (nt >= 4) {
                    cname = toks[2].str();
                    val = strtod(toks[3].p, nullptr);
                } else if (nt >= 3) {
                    cname = toks[1].str();
                    val = strtod(toks[2].p, nullptr);
                }
                auto it = col_index.find(cname);
                if (it == col_index.end()) {
                    cd->error = "BOUNDS references unknown column";
                    fclose(fh);
                    return cd;
                }
                int32_t j = it->second;
                if (btype == "UP") {
                    cd->ub[j] = val;
                    if (val < 0 && cd->lb[j] == 0.0) cd->lb[j] = -kInf;
                } else if (btype == "LO") cd->lb[j] = val;
                else if (btype == "FX") { cd->lb[j] = val; cd->ub[j] = val; }
                else if (btype == "FR") { cd->lb[j] = -kInf; cd->ub[j] = kInf; }
                else if (btype == "MI") cd->lb[j] = -kInf;
                else if (btype == "PL") cd->ub[j] = kInf;
                else if (btype == "BV") {
                    cd->lb[j] = 0.0; cd->ub[j] = 1.0; cd->is_int[j] = 1;
                } else if (btype == "LI") {
                    cd->lb[j] = val; cd->is_int[j] = 1;
                } else if (btype == "UI") {
                    cd->ub[j] = val; cd->is_int[j] = 1;
                } else {
                    cd->error = "unknown bound type " + btype;
                    fclose(fh);
                    return cd;
                }
                break;
            }
            case NONE:
            default:
                cd->error = "data line outside any section";
                fclose(fh);
                return cd;
        }
    }
    fclose(fh);

    if (!have_obj && cd->error.empty())
        cd->error = "core file has no objective (N) row";

    // RANGES lowering (same semantics as the Python parser's _apply_ranges:
    // equality row + one slack column in [0, |range|]; +1 slack when the
    // original rhs is the UPPER side, -1 when it is the LOWER side).
    for (auto& kv : range_vals) {
        int32_t i = kv.first;
        double v = kv.second;
        double coef;
        if (cd->sense[i] == -1) coef = 1.0;            // L row
        else if (cd->sense[i] == 1) coef = -1.0;       // G row
        else coef = (v >= 0) ? -1.0 : 1.0;             // E row
        cd->sense[i] = 0;
        int32_t j = (int32_t)cd->col_names.size();
        cd->col_names.push_back(cd->row_names[i] + "$RNG");
        cd->obj.push_back(0.0);
        cd->lb.push_back(0.0);
        cd->ub.push_back(std::fabs(v));
        cd->is_int.push_back(0);
        cd->mat_row.push_back(i);
        cd->mat_col.push_back(j);
        cd->mat_val.push_back(coef);
        cd->range_rows.push_back(i);
        cd->range_cols.push_back(j);
    }

    if (objsense == -1)
        for (auto& v : cd->obj) v = -v;

    // Flatten names.
    for (size_t i = 0; i < cd->row_names.size(); ++i) {
        if (i) cd->row_blob += '\n';
        cd->row_blob += cd->row_names[i];
    }
    for (size_t i = 0; i < cd->col_names.size(); ++i) {
        if (i) cd->col_blob += '\n';
        cd->col_blob += cd->col_names[i];
    }
    return cd;
}

const char* sd_core_error(void* h) {
    auto* cd = static_cast<CoreData*>(h);
    return cd->error.empty() ? nullptr : cd->error.c_str();
}

int64_t sd_core_nrows(void* h) { return static_cast<CoreData*>(h)->row_names.size(); }
int64_t sd_core_ncols(void* h) { return static_cast<CoreData*>(h)->col_names.size(); }
int64_t sd_core_nnz(void* h) { return static_cast<CoreData*>(h)->mat_val.size(); }
double sd_core_obj_constant(void* h) { return static_cast<CoreData*>(h)->obj_constant; }
const char* sd_core_name(void* h) { return static_cast<CoreData*>(h)->name.c_str(); }
const char* sd_core_objname(void* h) { return static_cast<CoreData*>(h)->objname.c_str(); }
const char* sd_core_row_names(void* h) { return static_cast<CoreData*>(h)->row_blob.c_str(); }
const char* sd_core_col_names(void* h) { return static_cast<CoreData*>(h)->col_blob.c_str(); }
const double* sd_core_rhs(void* h) { return static_cast<CoreData*>(h)->rhs.data(); }
const int8_t* sd_core_sense(void* h) { return static_cast<CoreData*>(h)->sense.data(); }
const double* sd_core_obj(void* h) { return static_cast<CoreData*>(h)->obj.data(); }
const double* sd_core_lb(void* h) { return static_cast<CoreData*>(h)->lb.data(); }
const double* sd_core_ub(void* h) { return static_cast<CoreData*>(h)->ub.data(); }
const uint8_t* sd_core_is_int(void* h) { return static_cast<CoreData*>(h)->is_int.data(); }
int64_t sd_core_nranges(void* h) { return static_cast<CoreData*>(h)->range_rows.size(); }
const int32_t* sd_core_range_rows(void* h) { return static_cast<CoreData*>(h)->range_rows.data(); }
const int32_t* sd_core_range_cols(void* h) { return static_cast<CoreData*>(h)->range_cols.data(); }
const int32_t* sd_core_mat_row(void* h) { return static_cast<CoreData*>(h)->mat_row.data(); }
const int32_t* sd_core_mat_col(void* h) { return static_cast<CoreData*>(h)->mat_col.data(); }
const double* sd_core_mat_val(void* h) { return static_cast<CoreData*>(h)->mat_val.data(); }

void sd_free_core(void* h) { delete static_cast<CoreData*>(h); }

}  // extern "C"
