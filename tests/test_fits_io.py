"""FITS codec and table round-trip tests."""

import io

import numpy as np
import pytest
from numpy.testing import assert_allclose, assert_array_equal

from muse_psfr_tpu.io.fits import (HDUList, PrimaryHDU, ImageHDU,
                                   BinTableHDU, Header, fits_open,
                                   fits_getheader)
from muse_psfr_tpu.io.table import FitTable
from muse_psfr_tpu.io.sparta import create_sparta_table, read_sparta_values


def _roundtrip(hdul):
    buf = io.BytesIO()
    hdul.writeto(buf)
    buf.seek(0)
    return fits_open(buf)


def test_header_values_roundtrip():
    h = Header()
    h["SEEING"] = 1.25
    h["GL"] = 0.7
    h["NVAL"] = 42
    h["FLAG"] = True
    h["NAME"] = "it's a test"
    hdul = _roundtrip(HDUList([PrimaryHDU(header=h)]))
    hh = hdul[0].header
    assert hh["SEEING"] == 1.25
    assert hh["GL"] == 0.7
    assert hh["NVAL"] == 42
    assert hh["FLAG"] is True
    assert hh["NAME"] == "it's a test"


def test_image_hdu_roundtrip():
    rng = np.random.default_rng(0)
    cube = rng.normal(size=(3, 7, 5))
    hdul = _roundtrip(HDUList([PrimaryHDU(),
                               ImageHDU(data=cube, name="PSF_MEAN")]))
    assert hdul["PSF_MEAN"].data.shape == (3, 7, 5)
    assert_allclose(hdul["PSF_MEAN"].data, cube)


def test_bintable_vector_columns_roundtrip():
    t = FitTable()
    t["lbda"] = np.array([500.0, 700.0])
    t["fwhm"] = np.array([[4.1, 4.1], [3.2, 3.2]])
    t["row_idx"] = np.array([1, 2], dtype=np.int64)
    t.meta["SEEING"] = 1.0
    hdul = _roundtrip(HDUList([PrimaryHDU(), t.to_hdu("FIT_ROWS")]))
    t2 = FitTable.from_hdu(hdul["FIT_ROWS"])
    assert_allclose(t2["lbda"], t["lbda"])
    assert_allclose(t2["fwhm"], t["fwhm"])
    assert_array_equal(t2["row_idx"], t["row_idx"])
    assert t2.meta["SEEING"] == 1.0


def test_reads_idl_written_reference_data():
    """The codec must read the IDL-written coeffL0 table from 2018.

    The table ships with the reference ``muse-psfr`` checkout, named by
    ``$MUSE_PSFR_REFERENCE_DIR``; the test skips where that is unset or
    holds no table."""
    import os
    ref = os.environ.get("MUSE_PSFR_REFERENCE_DIR")
    if not ref:
        pytest.skip("MUSE_PSFR_REFERENCE_DIR (a reference muse-psfr "
                    "checkout) is not set")
    path = os.path.join(ref, "muse_psfr", "coeffL0.fits")
    if not os.path.exists(path):
        pytest.skip(f"reference muse-psfr checkout not found ({path})")
    hdul = fits_open(path)
    data = hdul[0].data
    assert data.shape == (2, 200)
    assert_allclose(data[0][:3], [1, 2, 3])
    assert abs(data[1][-1] - 1.0423263) < 1e-6


def test_sparta_table_and_reader(tmp_path):
    path = str(tmp_path / "sparta.fits")
    create_sparta_table(nlines=3, seeing=0.9, GL=0.6, L0=22, bad_l0=True,
                        outfile=path)
    values, hdul = read_sparta_values(path)
    assert values.shape == (3, 4, 3)
    assert_allclose(values[:, 0, :], [[0.9, 0.6, 22]] * 3)
    assert_allclose(values[:, 3, 2], 150)
    # header access used by the CLI raw path
    hdr = fits_getheader(path)
    assert hdr.get("HIERARCH ESO OBS NAME") is None


def test_hierarch_header_roundtrip():
    h = Header()
    h["HIERARCH ESO OBS NAME".replace("HIERARCH ", "")] = "obs1"
    h["ESO TEL AIRM START"] = 1.13
    hdul = _roundtrip(HDUList([PrimaryHDU(header=h)]))
    hh = hdul[0].header
    assert hh.get("ESO OBS NAME") == "obs1"
    assert hh.get("ESO TEL AIRM START") == 1.13


def test_logical_column_roundtrip():
    """Logical ('L') columns use ASCII T/F bytes on disk (FITS standard)."""
    arr = np.empty(3, dtype=np.dtype([("FLAG", np.bool_), ("V", "f8")]))
    arr["FLAG"] = [True, False, True]
    arr["V"] = [1.0, 2.0, 3.0]
    hdul = _roundtrip(HDUList([PrimaryHDU(),
                               BinTableHDU(data=arr, name="T")]))
    back = hdul["T"].data
    assert back["FLAG"].dtype.kind == "b"
    assert list(back["FLAG"]) == [True, False, True]
    # on-disk bytes really are 'T'/'F'
    import io as _io
    buf = _io.BytesIO()
    HDUList([PrimaryHDU(), BinTableHDU(data=arr, name="T")]).writeto(buf)
    raw = buf.getvalue()
    assert b"T" in raw[2880 * 2:] and b"F" in raw[2880 * 2:]


def test_random_table_roundtrips():
    """Property-style: random mixed-dtype tables survive a round trip."""
    rng = np.random.default_rng(7)
    for trial in range(5):
        ncol = rng.integers(1, 6)
        fields, cols = [], {}
        for c in range(ncol):
            name = "C%d" % c
            kind = rng.integers(0, 4)
            n = int(rng.integers(1, 9))
            if kind == 0:
                fields.append((name, "f8"))
                cols[name] = rng.normal(size=n if c == 0 else len0)
            elif kind == 1:
                fields.append((name, "f4"))
                cols[name] = rng.normal(size=n if c == 0 else len0).astype("f4")
            elif kind == 2:
                fields.append((name, "i8"))
                cols[name] = rng.integers(-5, 5, size=n if c == 0 else len0)
            else:
                fields.append((name, "f8", (3,)))
                cols[name] = rng.normal(size=((n if c == 0 else len0), 3))
            if c == 0:
                len0 = len(cols[name])
        arr = np.empty(len0, dtype=np.dtype(fields))
        for k, v in cols.items():
            arr[k] = v
        hdul = _roundtrip(HDUList([PrimaryHDU(),
                                   BinTableHDU(data=arr, name="R")]))
        back = hdul["R"].data
        for k in cols:
            assert_allclose(np.asarray(back[k], np.float64),
                            np.asarray(arr[k], np.float64), rtol=1e-6)


def test_hierarch_prefix_lookup():
    """Both astropy spellings must resolve: with and without 'HIERARCH '."""
    h = Header()
    h["HIERARCH ESO OBS NAME"] = "obs2"
    assert h["ESO OBS NAME"] == "obs2"
    assert h["HIERARCH ESO OBS NAME"] == "obs2"
    assert h.get("HIERARCH ESO TEL AIRM START", 0) == 0
    hdul = _roundtrip(HDUList([PrimaryHDU(header=h)]))
    assert hdul[0].header.get("HIERARCH ESO OBS NAME") == "obs2"


def test_unsupported_image_dtype_raises():
    import pytest
    with pytest.raises(TypeError):
        HDUList([PrimaryHDU(),
                 ImageHDU(data=np.arange(6, dtype=np.complex64
                                         ).reshape(2, 3))
                 ]).writeto(io.BytesIO())


def test_unsigned_image_roundtrip_bzero_convention():
    """Unsigned integer images use the FITS BZERO convention (signed
    storage + sign-bit offset) — the layout of every raw MUSE CHAN
    extension.  Values spanning the full range must round-trip with the
    unsigned dtype preserved, and the scaling keywords must NOT survive
    into the data-adjusted header copy (double-apply hazard)."""
    for dt, lo, hi in ((np.uint16, 0, 65535), (np.uint32, 0, 2**32 - 1),
                      (np.uint64, 0, 2**64 - 1)):
        a = np.array([[lo, 1, 2], [3, 4, hi]], dtype=dt)
        buf = io.BytesIO()
        HDUList([PrimaryHDU(), ImageHDU(data=a, name="U")]).writeto(buf)
        buf.seek(0)
        back = fits_open(buf)["U"]
        assert back.data.dtype == dt
        np.testing.assert_array_equal(back.data, a)
        # re-serialise the read HDU: values must survive a second cycle
        # (regression: BZERO used to be copied back AND the data left
        # scaled, doubling the offset every round trip)
        buf2 = io.BytesIO()
        HDUList([PrimaryHDU(), back]).writeto(buf2)
        buf2.seek(0)
        np.testing.assert_array_equal(fits_open(buf2)["U"].data, a)


def test_bzero_int16_no_overflow():
    """BITPIX 16 + BZERO 32768 (the standard unsigned convention) must
    not raise OverflowError on NumPy 2 ('Python integer 32768 out of
    bounds for int16') — it crashed the CLI on every real raw MUSE
    exposure."""
    h = Header()
    h["SIMPLE"] = True
    h["BITPIX"] = 16
    h["NAXIS"] = 2
    h["NAXIS1"] = 2
    h["NAXIS2"] = 1
    h["BZERO"] = 32768
    h["BSCALE"] = 1
    raw = np.array([[-32768, 32767]], dtype=">i2").tobytes()
    blob = h.tobytes() + raw + b"\x00" * ((-len(raw)) % 2880)
    data = fits_open(io.BytesIO(blob))[0].data
    assert data.dtype == np.uint16
    np.testing.assert_array_equal(data, [[0, 65535]])
    # a general (non-convention) scaling promotes to float64
    h["BZERO"] = 100
    h["BSCALE"] = 2
    blob = h.tobytes() + raw + b"\x00" * ((-len(raw)) % 2880)
    data = fits_open(io.BytesIO(blob))[0].data
    assert data.dtype == np.float64
    np.testing.assert_array_equal(data, [[-65436.0, 65634.0]])


def test_int8_column_rejected_loudly():
    """TFORM 'B' is unsigned: writing an int8 column through it would
    silently wrap negative values, so it must raise like every other
    unsupported dtype."""
    import pytest
    rec = np.zeros(2, dtype=[("a", "i1")])
    rec["a"] = [-5, 3]
    with pytest.raises(TypeError, match="column dtype"):
        BinTableHDU(data=rec, name="T").writeto(io.BytesIO())


def test_undefined_header_value_roundtrips():
    """Cards with an undefined (blank) value — legal FITS, present in
    real raw headers — must parse to None and write back out instead of
    crashing the final writeto after a full reconstruction."""
    h = Header()
    h["UNDEF"] = (None, "no value, only a comment")
    h["AFTER"] = 1
    buf = io.BytesIO()
    HDUList([PrimaryHDU(header=h)]).writeto(buf)
    buf.seek(0)
    rh = fits_open(buf)[0].header
    assert rh["UNDEF"] is None
    assert rh.comments["UNDEF"] == "no value, only a comment"
    assert rh["AFTER"] == 1


def test_string_values_pad_inside_quotes():
    """Fixed-format rule (FITS 4.0 sect 4.2.1.1): string values pad to
    >= 8 chars INSIDE the quotes — XTENSION= 'IMAGE   ' not 'IMAGE'."""
    buf = io.BytesIO()
    HDUList([PrimaryHDU(),
             ImageHDU(data=np.zeros((2, 2), np.float32), name="X")
             ]).writeto(buf)
    raw = buf.getvalue()
    cards = [raw[i:i + 80].decode("ascii") for i in range(0, len(raw), 80)]
    xt = [c for c in cards if c.startswith("XTENSION")][0]
    assert xt.startswith("XTENSION= 'IMAGE   '")


def test_writeto_overwrite_false_refuses(tmp_path):
    import pytest
    p = str(tmp_path / "x.fits")
    hl = HDUList([PrimaryHDU()])
    hl.writeto(p)
    with pytest.raises(OSError, match="overwrite"):
        hl.writeto(p, overwrite=False)
    hl.writeto(p, overwrite=True)          # explicit overwrite works


def test_scaled_table_column_read():
    """TSCALn/TZEROn columns scale to physical values on read (astropy
    semantics): the unsigned convention yields the unsigned dtype,
    anything else float64; the scaling keywords are stripped on
    re-write so the values never double-apply."""
    h = Header()
    h["XTENSION"] = "BINTABLE"
    h["BITPIX"] = 8
    h["NAXIS"] = 2
    h["NAXIS1"] = 4
    h["NAXIS2"] = 2
    h["PCOUNT"] = 0
    h["GCOUNT"] = 1
    h["TFIELDS"] = 2
    h["TTYPE1"] = "u"
    h["TFORM1"] = "I"
    h["TZERO1"] = 32768
    h["TTYPE2"] = "s"
    h["TFORM2"] = "I"
    h["TSCAL2"] = 0.5
    h["TZERO2"] = 10
    h["EXTNAME"] = "SC"
    rows = np.zeros(2, dtype=[("u", ">i2"), ("s", ">i2")])
    rows["u"] = [-32768, 32767]
    rows["s"] = [4, -2]
    raw = rows.tobytes()
    blob = (Header([("SIMPLE", True, ""), ("BITPIX", 8, ""),
                    ("NAXIS", 0, ""), ("EXTEND", True, "")]).tobytes()
            + h.tobytes() + raw + b"\x00" * ((-len(raw)) % 2880))
    t = fits_open(io.BytesIO(blob))["SC"]
    assert t.data["u"].dtype == np.uint16
    np.testing.assert_array_equal(t.data["u"], [0, 65535])
    assert t.data["s"].dtype == np.float64
    np.testing.assert_array_equal(t.data["s"], [12.0, 9.0])
    # re-write: stale scaling keywords are stripped (the unsigned
    # column legitimately re-emits its own TZERO1; the float64 column
    # must carry none) and the values survive a second cycle unchanged
    buf = io.BytesIO()
    out = BinTableHDU(data=np.asarray(t.data), name="SC",
                      header=t.header)
    out.writeto(buf)
    buf.seek(0)
    rh = fits_open(buf)["SC"]
    assert "TSCAL2" not in rh.header and "TZERO2" not in rh.header
    assert rh.data["u"].dtype == np.uint16
    np.testing.assert_array_equal(rh.data["u"], [0, 65535])
    np.testing.assert_array_equal(rh.data["s"], [12.0, 9.0])


def test_lazy_decode_and_unsupported_extension(tmp_path):
    """Payloads decode lazily: opening a file with an extension type the
    codec cannot decode (ASCII TABLE) must succeed, name-based lookup
    must reach the HDUs behind it, and only accessing the unsupported
    .data raises."""
    import pytest
    # hand-build: PRIMARY | TABLE (unsupported) | IMAGE 'GOOD'
    prim = Header([("SIMPLE", True, ""), ("BITPIX", 8, ""),
                   ("NAXIS", 0, ""), ("EXTEND", True, "")]).tobytes()
    tbl = Header([("XTENSION", "TABLE", ""), ("BITPIX", 8, ""),
                  ("NAXIS", 2, ""), ("NAXIS1", 10, ""), ("NAXIS2", 3, ""),
                  ("PCOUNT", 0, ""), ("GCOUNT", 1, ""), ("TFIELDS", 1, ""),
                  ("TFORM1", "A10", ""), ("EXTNAME", "ASCII", "")])
    tpay = b"x" * 30
    img = np.arange(4, dtype=np.float32).reshape(2, 2)
    buf = io.BytesIO()
    HDUList([PrimaryHDU(), ImageHDU(data=img, name="GOOD")]).writeto(buf)
    good_bytes = buf.getvalue()[2880:]     # the IMAGE extension blocks
    blob = (prim + tbl.tobytes() + tpay + b"\x00" * ((-30) % 2880)
            + good_bytes)
    p = str(tmp_path / "mixed.fits")
    open(p, "wb").write(blob)
    hdul = fits_open(p)                    # must not raise
    assert [h.name for h in hdul] == ["PRIMARY", "ASCII", "GOOD"]
    np.testing.assert_array_equal(hdul["GOOD"].data, img)
    with pytest.raises(NotImplementedError, match="TABLE"):
        hdul["ASCII"].data


def test_fits_open_rejects_malformed_inputs():
    """Truncated/empty/garbage inputs raise OSError with a clear message
    (astropy parity), never return a confusing partial HDUList."""
    import io
    import numpy as np
    import pytest
    from muse_psfr_tpu.io.fits import fits_open
    from muse_psfr_tpu import create_sparta_table, HDUList

    buf = io.BytesIO()
    HDUList([create_sparta_table(nlines=2)]).writeto(buf)
    data = buf.getvalue()
    for blob in (b"", data[:100], b"NOT A FITS FILE" * 200):
        with pytest.raises(OSError):
            fits_open(io.BytesIO(blob))
    # the intact bytes still round-trip
    h = fits_open(io.BytesIO(data))
    assert [x.name for x in h][0] == "PRIMARY"


def test_long_string_card_continue_roundtrip():
    """String values past column 80 use the FITS long-string (CONTINUE)
    convention instead of silently truncating — the reference gets this
    from astropy, whose headers the CLI copies out of raw MUSE files
    (reference cli.py:44-55)."""
    import pytest

    long_val = ("MUSE observation of an extremely long target name "
                "with embedded 'quotes' and trailing detail " * 3).strip()
    h = Header()
    h["OBJECT"] = long_val
    h["LONGC"] = ("short", "a comment that is much too long to fit on one "
                  "eighty-column card image and must continue " * 2)
    hdul = _roundtrip(HDUList([PrimaryHDU(header=h)]))
    assert hdul[0].header["OBJECT"] == long_val
    assert hdul[0].header["LONGC"] == "short"

    # the card images themselves stay standard-conformant 80-col records
    raw = h.tobytes()
    assert len(raw) % 2880 == 0
    cards = [raw[i:i + 80].decode("ascii") for i in range(0, len(raw), 80)]
    assert any(c.startswith("CONTINUE  ") for c in cards)
    # every non-final segment of OBJECT ends with the '&' sentinel
    start = next(i for i, c in enumerate(cards) if c.startswith("OBJECT"))
    obj_cards = [cards[start]]
    for c in cards[start + 1:]:
        if not c.startswith("CONTINUE"):
            break
        obj_cards.append(c)
    assert len(obj_cards) > 1
    for c in obj_cards[:-1]:
        assert "&'" in c

    # cards that CANNOT be continued fail loudly, never corrupt
    h2 = Header()
    h2["HIERARCH ESO OBS LONG NAME"] = "x" * 80
    with pytest.raises(ValueError):
        h2.tobytes()


def test_long_string_quote_runs_roundtrip():
    """The CONTINUE segment splitter must never cut an escaped ''
    pair in half: quote-heavy values pin the pair-alignment logic
    (io/fits.py:_string_card_images)."""
    values = [
        "a" + "'" * 57 + "b" * 60,     # long quote run mid-value
        "'" * 100,                     # nothing but quotes
        "x" * 66 + "'" + "y" * 60,     # single quote at the cut column
        "x" * 120 + "'" * 7,           # odd trailing quote run
    ]
    for val in values:
        h = Header()
        h["OBJECT"] = val
        raw = h.tobytes()
        assert len(raw) % 2880 == 0
        hdul = _roundtrip(HDUList([PrimaryHDU(header=h)]))
        assert hdul[0].header["OBJECT"] == val


def test_reads_externally_written_continue_header():
    """A standard-conformant CONTINUE header written by another library
    (byte-exact astropy layout, hand-built) parses to the full value."""
    val = ("A very long OBS NAME written by astropy into a raw MUSE "
           "header that spans multiple card images for sure........")
    seg1, seg2 = val[:60], val[60:]
    cards = [
        "SIMPLE  =                    T",
        "BITPIX  =                    8",
        "NAXIS   =                    0",
        "LONGSTRN= 'OGIP 1.0'           / The OGIP long string convention may be used.",
        "OBJECT  = '%s&'" % seg1,
        "CONTINUE  '%s' / a comment" % seg2,
        "END",
    ]
    raw = "".join(c.ljust(80) for c in cards).encode("ascii")
    raw += b" " * ((-len(raw)) % 2880)
    hdul = fits_open(io.BytesIO(raw))
    assert hdul[0].header["OBJECT"] == val


def test_card_comments_roundtrip():
    """Inline card comments survive a write/read cycle — the reference
    copies raw-MUSE headers through astropy, which preserves comments;
    silently dropping them on read would degrade every header copy.
    Covers numeric, boolean, string (incl. a '/' INSIDE the quoted
    value), HIERARCH, and a long-string value whose long comment rides
    CONTINUE cards, including a comment split at a space boundary."""
    h = Header()
    h["EXPTIME"] = (3600, "integration time [s]")
    h["SIMPLE2"] = (True, "conforms / mostly")
    h["RATIO"] = (0.25, "a quarter")
    h["PATH"] = ("a/b/c", "slash inside the value")
    h["HIERARCH ESO OBS T"] = (5, "hierarch comment")
    long_comment = ("this comment is far too long for one eighty column "
                    "card and must ride the CONTINUE cards while keeping "
                    "every single space between words intact " * 2).strip()
    h["TARGET"] = ("NGC 300 ultra deep field " * 5, long_comment)

    hdul = _roundtrip(HDUList([PrimaryHDU(header=h)]))
    rh = hdul[0].header
    assert rh.comments["EXPTIME"] == "integration time [s]"
    assert rh.comments["SIMPLE2"] == "conforms / mostly"
    assert rh["SIMPLE2"] is True
    assert rh.comments["RATIO"] == "a quarter"
    assert rh["PATH"] == "a/b/c"
    assert rh.comments["PATH"] == "slash inside the value"
    assert rh.comments["ESO OBS T"] == "hierarch comment"
    assert rh["TARGET"] == ("NGC 300 ultra deep field " * 5).rstrip() \
        or rh["TARGET"] == "NGC 300 ultra deep field " * 5
    assert rh.comments["TARGET"] == long_comment


def test_empty_string_value_with_long_comment_roundtrips():
    """An empty string value whose comment overflows the card must still
    emit the keyword card (regression: the CONTINUE segment splitter
    produced zero segments for '', so the header started with orphan
    CONTINUE cards and the keyword was silently lost on round-trip)."""
    h = Header()
    h["MYKEY"] = ("", "x" * 70)
    raw = h.tobytes()
    cards = [raw[i:i + 80].decode("ascii") for i in range(0, len(raw), 80)]
    assert cards[0].startswith("MYKEY   = ")
    hdul = _roundtrip(HDUList([PrimaryHDU(header=h)]))
    rh = hdul[0].header
    assert rh["MYKEY"] == ""
    assert rh.comments["MYKEY"] == "x" * 70


def test_exact_80_column_card_unchanged():
    """Values that exactly fill one card stay on one card (no gratuitous
    CONTINUE)."""
    # '%-8s= ' + quote + 66 chars + quote = exactly 80 columns
    v = "x" * 66
    h = Header()
    h["KEY"] = v
    raw = h.tobytes()
    cards = [raw[i:i + 80].decode("ascii") for i in range(0, len(raw), 80)]
    assert not any(c.startswith("CONTINUE") for c in cards)
    buf = io.BytesIO()
    HDUList([PrimaryHDU(header=h)]).writeto(buf)
    buf.seek(0)
    assert fits_open(buf)[0].header["KEY"] == v


def test_overlong_comment_truncates_like_astropy():
    """An overlong COMMENT on a card whose value fits is truncated with
    a warning (astropy writes the same truncated card under a
    VerifyWarning) — it must not abort the file write.  Only VALUES
    fail loudly when uncontinuable."""
    h = Header()
    h["EXPTIME"] = (3600, "c" * 120)
    h["HIERARCH ESO OBS X"] = (5, "d" * 100)
    raw = h.tobytes()
    assert len(raw) % 2880 == 0
    cards = [raw[i:i + 80].decode("ascii") for i in range(0, len(raw), 80)]
    assert cards[0].startswith("EXPTIME =                 3600 / ccc")
    assert len(cards[0]) == 80
    hdul = _roundtrip(HDUList([PrimaryHDU(header=h)]))
    assert hdul[0].header["EXPTIME"] == 3600
    assert hdul[0].header["ESO OBS X"] == 5


def test_vector_string_column_rejected_loudly():
    """A (S<n>, (k,)) column would need TFORM '<n*k>A' + TDIM to
    round-trip; emitting '<n>A' would silently corrupt the row layout
    (NAXIS1 vs the TFORM sum).  The codec must refuse, not corrupt."""
    import io as _io

    import pytest

    data = np.zeros(2, dtype=[("name", "S4", (3,)), ("x", "f8")])
    hdu = BinTableHDU(data=data, name="BAD")
    with pytest.raises(TypeError, match="vector string"):
        HDUList([PrimaryHDU(), hdu]).writeto(_io.BytesIO())
    # scalar string columns still round-trip
    ok = np.zeros(2, dtype=[("name", "S4"), ("x", "f8")])
    ok["name"] = [b"ab", b"cdef"]
    ok["x"] = [1.5, -2.0]
    hdul = _roundtrip(HDUList([PrimaryHDU(), BinTableHDU(data=ok,
                                                         name="OK")]))
    assert_array_equal(hdul["OK"].data["name"], ok["name"])
    assert_allclose(hdul["OK"].data["x"], ok["x"])
