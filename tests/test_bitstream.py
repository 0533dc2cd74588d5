import random

from ffvvc_jax.bitstream import (BitReader, BitWriter, split_annexb, write_nal,
                                 insert_epb, remove_epb, NalType)


def test_bit_io_roundtrip():
    random.seed(0)
    for _ in range(50):
        ops = []
        w = BitWriter()
        for _ in range(random.randrange(1, 100)):
            kind = random.choice(["u", "ue", "se"])
            if kind == "u":
                n = random.randrange(1, 32)
                v = random.randrange(1 << n)
                w.u(v, n)
            elif kind == "ue":
                n, v = None, random.randrange(100000)
                w.ue(v)
            else:
                n, v = None, random.randrange(-5000, 5000)
                w.se(v)
            ops.append((kind, n, v))
        w.rbsp_trailing_bits()
        r = BitReader(w.bytes())
        for kind, n, v in ops:
            got = r.u(n) if kind == "u" else (r.ue() if kind == "ue" else r.se())
            assert got == v
        r.rbsp_trailing_bits()


def test_epb_roundtrip():
    random.seed(1)
    for _ in range(300):
        data = bytes(random.choice([0, 0, 0, 1, 2, 3, 255])
                     for _ in range(random.randrange(0, 80)))
        enc = insert_epb(data)
        for pat in (b"\x00\x00\x00", b"\x00\x00\x01", b"\x00\x00\x02"):
            assert pat not in enc
        dec, _ = remove_epb(enc)
        assert dec == data


def test_nal_split():
    payload = bytes([0x80]) + b"\x00\x00\x01\x00\x00\x02" * 4
    stream = write_nal(NalType.SPS, b"\x12\x34") + \
        write_nal(NalType.IDR_N_LP, payload, long_startcode=False)
    nals = split_annexb(stream)
    assert [n.nal_unit_type for n in nals] == [NalType.SPS, NalType.IDR_N_LP]
    assert nals[0].rbsp == b"\x12\x34"
    assert nals[1].rbsp == payload
