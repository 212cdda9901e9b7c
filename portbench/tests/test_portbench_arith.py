"""The benchmark's frozen arithmetic against hand-worked SmolLM-360M and
Mamba-2 780M numbers."""
import json

import pb_env

from portbench import arith

SMOL = json.loads((pb_env.ROOT / "portbench/configs/smollm-360m.json")
                  .read_text())["model"]
MAMBA = json.loads((pb_env.ROOT / "portbench/configs/mamba2-780m.json")
                   .read_text())["model"]


def test_smollm_flops_per_token():
    # a layer: q 2*960*960, k and v 2*2*960*320, o 2*960*960, the MLP
    # 6*960*2560 = 19,660,800; attention 4*960 a context position
    # 32 layers + the unembedding 2*960*49152 = 94,371,840
    assert arith.flops_per_token(SMOL, 1) == 723_517_440 + 122_880
    assert arith.flops_per_token(SMOL, 513) == 786_554_880
    # 64 steps from position 512, batch 8
    assert arith.generate_flops(SMOL, 8, 512, 64) == 404_697_907_200


def test_mamba2_flops_per_token():
    # a layer: in_proj 2*1536*6448, conv 2*4*3328, the state 4*48*64*128,
    # out_proj 2*3072*1536 = 30,844,928; 48 layers + 2*1536*50280
    assert arith.ssm_dims(MAMBA) == (3072, 48, 3328, 6448)
    assert arith.flops_per_token(MAMBA, 1) == 1_635_016_704
    assert arith.flops_per_token(MAMBA, 576) == 1_635_016_704


def test_smollm_commit_and_undo_bytes():
    # K and V [32, 8, 576, 5, 64] bf16; a row of one layer and sequence is
    # 368,640 B, its slots 512..575 cover 3 chunks of 16 KiB, aligned or
    # not: 2 * 256 * 3 = 1,536 chunks, plus index, last_tok, generated
    c = arith.cell_bytes(SMOL, 8, 512, 64, 16384)
    assert c == {"written": 188_745_888, "dirty": 25_168_032,
                 "chunks": 1_539}
    assert arith.commit_least_bytes(SMOL, 8, 512, 64, 16384) == 213_913_920
    assert arith.undo_least_bytes(SMOL, 8, 512, 64, 16384) == 50_331_968


def test_mamba2_commit_and_undo_bytes():
    # conv [48, 8, 3, 3328] bf16 = 7,667,712 (8 chunks of 1 MiB), state
    # [48, 8, 48, 64, 128] float32 = 603,979,776 (576), rewritten whole
    c = arith.cell_bytes(MAMBA, 8, 512, 64, 1 << 20)
    assert c == {"written": 611_649_568, "dirty": 611_649_568,
                 "chunks": 586}
    assert arith.commit_least_bytes(MAMBA, 8, 512, 64, 1 << 20) \
        == 1_223_299_136
    assert arith.undo_least_bytes(MAMBA, 8, 512, 64, 1 << 20) \
        == 1_223_295_040


def test_dirty_chunks_shared_between_rows():
    # [2, 4, 8] float32 written at slots 2..3 of axis 1: 32 B a slot, 128 B
    # a row; row 0 writes [64, 128), row 1 [192, 256)
    leaf = ("x", (2, 4, 8), "float32", 1)
    assert arith.dirty_chunks(leaf, 2, 2, 64) == 2      # chunks 1 and 3
    assert arith.dirty_chunks(leaf, 2, 2, 256) == 1     # both in chunk 0
    assert arith.dirty_chunks(leaf, 0, 4, 32) == 8      # every chunk
    assert arith.dirty_chunks(("y", (3,), "int32", None), 0, 1, 8) == 2


def test_peaks_and_least_seconds():
    assert arith.PEAK_BF16_FLOPS == 989e12
    assert arith.PEAK_HBM_BYTES_PER_S == 3.35e12
    assert arith.least_seconds(3.35e12) == 1.0
    assert arith.least_seconds(0, 989e12) == 1.0
    assert arith.least_seconds(3.35e9, 989e12) == 1.0
