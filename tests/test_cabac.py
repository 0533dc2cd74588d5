import random

from ffvvc_jax.cabac.engine import CabacDecoder, CabacEncoder, make_states, CTX


def test_engine_roundtrip():
    random.seed(3)
    for trial in range(10):
        qp = random.randrange(0, 64)
        it = random.randrange(3)
        ops = []
        for _ in range(random.randrange(1, 500)):
            k = random.random()
            if k < 0.6:
                ops.append(("ctx", random.randrange(CTX.NUM), random.randrange(2)))
            elif k < 0.85:
                ops.append(("byp", None, random.randrange(2)))
            elif k < 0.95:
                cmax = random.randrange(1, 60)
                ops.append(("tb", cmax, random.randrange(cmax + 1)))
            else:
                ops.append(("egk", random.randrange(3), random.randrange(2000)))
        enc = CabacEncoder(make_states(qp, it))
        for op, a, b in ops:
            if op == "ctx":
                enc.encode_bin(a, b)
            elif op == "byp":
                enc.encode_bypass(b)
            elif op == "tb":
                enc.truncated_binary(b, a)
            else:
                enc.limited_egk(b, a, 11, 15)
        enc.encode_terminate(1)
        data = enc.bytes_aligned()
        dec = CabacDecoder(data, 0, make_states(qp, it))
        for op, a, b in ops:
            if op == "ctx":
                assert dec.decode_bin(a) == b
            elif op == "byp":
                assert dec.decode_bypass() == b
            elif op == "tb":
                assert dec.truncated_binary(a) == b
            else:
                assert dec.limited_egk(a, 11, 15) == b
        assert dec.decode_terminate() == 1


def test_context_count():
    assert CTX.NUM == 378
