"""Extract normative H.266 constant tables into ffvvc_jax artifacts.

The tables extracted here are the *normative integer constants* of ITU-T
H.266 (CABAC context initValue/shiftIdx tables of clause 9.3.2.2, transform
matrices of 8.7.4, LFNST/MIP matrices, interpolation filter banks, ALF class
mappings, GPM tables). Every conforming VVC codec carries bit-identical
copies of these numbers; we pull them out of the reference tree's tables
(/root/reference/libavcodec/vvc/vvc_cabac.c, vvc_data.c) rather than
re-keying thousands of digits by hand. No code is taken — only the spec's
numeric data, reshaped into numpy arrays.

Run: python3 tools/extract_tables.py   (writes ffvvc_jax/cabac/_ctx_tables.npz
and ffvvc_jax/ops/_data_tables.npz)
"""
import json
import os
import re

import numpy as np

REF = "/root/reference/libavcodec"
OUT_CTX = os.path.join(os.path.dirname(__file__), "..", "ffvvc_jax", "cabac")
OUT_OPS = os.path.join(os.path.dirname(__file__), "..", "ffvvc_jax", "ops")


def strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    return text


def parse_enum_layout(src: str):
    """Parse `enum SyntaxElement { ... }` into an ordered {name: offset} map."""
    m = re.search(r"enum SyntaxElement \{(.*?)\};", src, flags=re.S)
    body = strip_comments(m.group(1))
    entries = [e.strip() for e in body.split(",") if e.strip()]
    names = {}
    order = []
    prev = -1
    for e in entries:
        if "=" in e:
            name, expr = [x.strip() for x in e.split("=", 1)]
            expr = expr.replace("CNU", "35")
            for known in sorted(names, key=len, reverse=True):
                expr = expr.replace(known, str(names[known]))
            val = eval(expr)  # arithmetic over ints only
        else:
            name = e
            val = prev + 1
        names[name] = val
        order.append(name)
        prev = val
    return names, order


def parse_init_values(src: str, n: int):
    m = re.search(
        r"static const uint8_t init_values\[4\]\[SYNTAX_ELEMENT_LAST\] = \{(.*?)\n\};",
        src, flags=re.S)
    body = strip_comments(m.group(1)).replace("CNU", "35")
    rows = []
    depth = 0
    cur = []
    for tok in re.findall(r"[{}]|\d+", body):
        if tok == "{":
            depth += 1
            cur = []
        elif tok == "}":
            depth -= 1
            if cur:
                rows.append(cur)
        else:
            cur.append(int(tok))
    rows = [r for r in rows if len(r) == n]
    assert len(rows) == 4, [len(r) for r in rows]
    return np.array(rows, dtype=np.uint8)


def extract_cabac():
    src = open(f"{REF}/vvc/vvc_cabac.c").read()
    names, order = parse_enum_layout(src)
    n = names["SYNTAX_ELEMENT_LAST"]
    init = parse_init_values(src, n)
    # layout: name -> (offset, count)
    layout = {}
    for i, name in enumerate(order):
        if name == "SYNTAX_ELEMENT_LAST":
            continue
        off = names[name]
        nxt = names[order[i + 1]]
        layout[name] = (off, nxt - off)
    os.makedirs(OUT_CTX, exist_ok=True)
    np.savez(os.path.join(OUT_CTX, "_ctx_tables.npz"), init_values=init)
    with open(os.path.join(OUT_CTX, "_ctx_layout.json"), "w") as f:
        json.dump({"num_contexts": n, "layout": layout}, f, indent=0, sort_keys=True)
    print(f"cabac: {n} contexts, init_values {init.shape}")


def parse_c_array_numbers(src: str, decl_regex: str):
    """Return the flat list of ints in the first C array matching decl_regex.

    src must already be comment-stripped (comments may contain braces/digits).
    """
    m = re.search(decl_regex + r"\s*=\s*\{", src)
    if not m:
        raise KeyError(decl_regex)
    i = m.end() - 1
    depth = 0
    start = i
    while True:
        c = src[i]
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                break
        i += 1
    return [int(x) for x in re.findall(r"-?\d+", src[start:i + 1])]


def extract_data():
    src = strip_comments(open(f"{REF}/vvc/vvc_data.c").read())
    src = re.sub(r"\bINV\b", "-1", src)  # INV sentinel in gpm weight idx table
    out = {}

    def grab(key, regex, shape=None, dtype=np.int32):
        nums = parse_c_array_numbers(src, regex)
        if shape is not None and -1 not in shape:
            want = int(np.prod(shape))
            if len(nums) < want:  # C zero-fills trailing elements
                nums = nums + [0] * (want - len(nums))
        arr = np.array(nums, dtype=np.int64).astype(dtype)
        if shape is not None:
            arr = arr.reshape(shape)
        out[key] = arr
        return arr

    # NOTE: DCT-2 / DST-7 / DCT-8 matrices are NOT extracted — they are
    # generated in closed form in ffvvc_jax/ops/data.py (8.7.4.3 kernels).
    # LFNST: [4 sets][2 matrices] (8.7.4.2)
    grab("lfnst_8x8", r"const int8_t ff_vvc_lfnst_8x8\[4\]\[2\]\[16\]\[48\]",
         (4, 2, 16, 48), np.int8)
    grab("lfnst_4x4", r"const int8_t ff_vvc_lfnst_4x4\[4\]\[2\]\[16\]\[16\]",
         (4, 2, 16, 16), np.int8)
    grab("lfnst_tr_set_index", r"const uint8_t ff_vvc_lfnst_tr_set_index\[95\]",
         (95,), np.uint8)
    # MIP matrices (8.4.5.2.3): three size classes
    grab("mip_4x4", r"static const uint8_t mip_matrix_4x4\[16\]\[16\]\[4\]",
         (16, 16, 4), np.uint8)
    grab("mip_8x8", r"static const uint8_t mip_matrix_8x8\[8\]\[16\]\[8\]",
         (8, 16, 8), np.uint8)
    grab("mip_16x16", r"static const uint8_t mip_matrix_16x16\[6\]\[64\]\[7\]",
         (6, 64, 7), np.uint8)
    # interpolation filters (8.5.6.3.2/3)
    grab("luma_filters", r"const int8_t ff_vvc_inter_luma_filters\[VVC_INTER_FILTER_TYPES\]\[VVC_INTER_LUMA_FACTS\]\[VVC_INTER_LUMA_TAPS\]",
         (3, 16, 8), np.int8)
    grab("chroma_filters", r"const int8_t ff_vvc_inter_chroma_filters\[VVC_INTER_FILTER_TYPES\]\[VVC_INTER_CHROMA_FACTS\]\[VVC_INTER_CHROMA_TAPS\]",
         (3, 32, 4), np.int8)
    grab("luma_dmvr_filters", r"const int8_t ff_vvc_inter_luma_dmvr_filters\[VVC_INTER_LUMA_DMVR_FACTS\]\[VVC_INTER_LUMA_DMVR_TAPS\]",
         (16, 2), np.int8)
    # intra fC filter: first 32x4 block; fG is the closed form
    # {16-(f>>1), 32-(f>>1), 16+(f>>1), f>>1} generated in ops/data.py
    nums = parse_c_array_numbers(
        src, r"const int8_t ff_vvc_intra_luma_filter\[VVC_INTRA_LUMA_TYPES\]\[VVC_INTRA_LUMA_FACTS\]\[VVC_INTRA_LUMA_TAPS\]")
    out["intra_filter_c"] = np.array(nums[:128], dtype=np.int8).reshape(32, 4)
    # ALF fixed filters (8.8.5.2)
    grab("alf_fix_filt_coeff", r"const int16_t ff_vvc_alf_fix_filt_coeff\[64\]\[12\]",
         (64, 12), np.int16)
    grab("alf_class_to_filt_map", r"const uint8_t ff_vvc_alf_class_to_filt_map\[16\]\[25\]",
         (16, 25), np.uint8)
    grab("alf_aps_class_to_filt_map", r"const uint8_t ff_vvc_alf_aps_class_to_filt_map\[25\]",
         (25,), np.uint8)
    # GPM (8.5.7): angles/distances/weights
    grab("gpm_angle_idx", r"const uint8_t ff_vvc_gpm_angle_idx\[VVC_GPM_NUM_PARTITION\]", (64,), np.uint8)
    grab("gpm_distance_idx", r"const uint8_t ff_vvc_gpm_distance_idx\[VVC_GPM_NUM_PARTITION\]", (64,), np.uint8)
    grab("gpm_distance_lut", r"const int8_t ff_vvc_gpm_distance_lut\[VVC_GPM_NUM_ANGLES\]", (32,), np.int8)
    grab("gpm_angle_to_mirror", r"const uint8_t ff_vvc_gpm_angle_to_mirror\[VVC_GPM_NUM_ANGLES\]", (32,), np.uint8)
    grab("gpm_angle_to_weights_idx", r"const uint8_t ff_vvc_gpm_angle_to_weights_idx\[VVC_GPM_NUM_ANGLES\]", (32,), np.uint8)
    grab("gpm_weights_offset_x", r"const uint8_t ff_vvc_gpm_weights_offset_x\[VVC_GPM_NUM_PARTITION\]\[4\]\[4\]", (64, 4, 4), np.uint8)
    grab("gpm_weights_offset_y", r"const uint8_t ff_vvc_gpm_weights_offset_y\[VVC_GPM_NUM_PARTITION\]\[4\]\[4\]", (64, 4, 4), np.uint8)
    grab("gpm_weights", r"const uint8_t ff_vvc_gpm_weights\[6\]\[VVC_GPM_WEIGHT_SIZE \* VVC_GPM_WEIGHT_SIZE\]", (6, 112 * 112), np.uint8)
    # scaling-list defaults (7.4.3.20)
    grab("scaling_pred_8", r"const uint8_t ff_vvc_scaling_pred_8\[8 \* 8\]", (64,), np.uint8)
    grab("scaling_pred_16", r"const uint8_t ff_vvc_scaling_pred_16\[8 \* 8\]", (64,), np.uint8)
    grab("scaling_list0", r"const int ff_vvc_scaling_list0\[8 \* 8\]", (64,), np.int32)
    # diagonal scans (6.5.2) are generated in ops/data.py (the C arrays are
    # partially-initialized and zero-padded, so flat extraction is unsound)
    os.makedirs(OUT_OPS, exist_ok=True)
    np.savez_compressed(os.path.join(OUT_OPS, "_data_tables.npz"), **out)
    total = sum(v.size for v in out.values())
    print(f"data: {len(out)} tables, {total} values")


if __name__ == "__main__":
    extract_cabac()
    extract_data()
