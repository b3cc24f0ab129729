"""Every public name of the JAX package has its counterpart in the port.

The test walks the AST of every ``.py`` under ``eccoxide_tpu/``, of the
JAX entry module and of the measurement scripts ``bench.py`` and
``bench_suite.py`` at the repository's root (it imports none of them, nor
JAX): the public module-level functions and classes (104), every
module-level function of the two scripts (13), the public module-level
constants and aliases with ``__version__`` (59), one entry for each
script's ``if __name__ == "__main__":`` block (3), and the public methods
of public classes (122). Each must have an entry in ``COUNTERPARTS``: a
port target ``"eccoxide_tpu_torch<.module>:<attr>"`` (a dotted attribute
path, resolved with importlib; a ``__main__`` entry names the ``main`` of
a port module that has its own ``__main__`` block), or ``("not ported",
reason)``, where the reason names the port code that does the name's
work. The not-ported entries are ROADMAP section 1's "Not to port" list:
the TPU forms (per-limb lists, the fused view, the 13-bit wide reduction,
the Pallas adapter and its lane tiling), one helper Python has built in,
the JAX compile cache and the TPU target of the JAX bench's record."""

import ast
import importlib
import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "eccoxide_tpu_torch"

_B_LIST = ("the TPU kernels' per-limb SSA lists: the port's fields take stacked "
           "(n, *batch) limbs (`field_sec2.py` `Field`, `field.py`), and the CUDA "
           "kernels of `ops/csrc/group.cu` keep the limbs in registers")
_FUSED = ("the fused limb-list view of the TPU kernels: `ops/csrc/group.cu`, "
          "`ops/csrc/pow_sec2.cuh` and `ops/csrc/pow448.cu` fuse the chains on the "
          "card; the fields of `field_sec2.py` and `field.py` are their plain versions")
_PALLAS = ("an adapter that sent a group's ops to the Pallas kernels: on CUDA tensors "
           "`curves/edwards.py` `EdwardsCurve` sends its adds and doubling runs to "
           "`ed_add`, `ed_add_mixed` and `ed_double` (`ops/group.py`, `ops/csrc/group.cu`)")


def _np(reason):
    return ("not ported", reason)


def _same(module, names, prefix=""):
    """{prefix + name: "eccoxide_tpu_torch.<module>:<prefix><name>"}"""
    return {prefix + n: f"eccoxide_tpu_torch.{module}:{prefix}{n}" for n in names}


def _keyed(path, entries):
    return {f"{path}:{k}": v for k, v in entries.items()}


_FIELD_SAME = ("const", "encode_ints", "decode_ints", "zero", "one", "bcast", "add", "sub",
               "neg", "double", "mul_small", "mul", "square", "canon", "is_zero", "eq",
               "select", "pow_const", "inverse", "inverse_bingcd", "is_square", "sqrt",
               "sqrt_ratio", "to_bytes_le", "to_bytes_be", "from_bytes_le", "from_bytes_be",
               "from_wide_bytes_le", "from_wide_bytes_be", "reduce_wide_bytes_le", "sgn0")
_B_OPS = ("b_loose", "b_stack", "b_carry", "b_add", "b_dbl", "b_neg", "b_sub",
          "b_mul_small", "b_const", "b_mul", "b_sq", "b_select")
_FUSED_OPS = ("mul", "square", "add", "sub", "double", "neg", "mul_small", "select", "const_b")
_ED_SAME = ("identity", "generator", "double", "add", "add_mixed", "neg", "select", "eq",
            "on_curve", "to_affine", "scalar_mul", "compress", "decompress")
_W_SAME = ("identity", "generator", "from_affine", "add", "double", "neg", "select", "eq",
           "is_identity", "on_curve", "to_affine", "from_coordinate", "affine_double",
           "affine_add_different", "scalar_mul", "mul_base", "compress", "decompress")

COUNTERPARTS = {
    "__init__.py:__version__": "eccoxide_tpu_torch:__version__",
    **_keyed("curves/curve25519.py", _same("curves.curve25519", (
        "decode_u", "x25519_ladder", "P", "L", "FQ", "FL", "MONT", "D", "ED_GY", "ED_GX",
        "EDWARDS", "MAP_C", "SQRT_M1"))),
    **_keyed("curves/curve448.py", _same("curves.curve448", (
        "decode_u", "x448_ladder", "P", "FQ", "MONT"))),
    **_keyed("curves/edwards.py", {
        "ExtPoint": "eccoxide_tpu_torch.curves.edwards:ExtPoint",
        "ExtPointB": _np("the per-limb point of the TPU kernels: `curves/edwards.py` "
                         "`ExtPoint` keeps (4, 10, *batch) coordinates, which "
                         "`ops/csrc/group.cu` takes whole"),
        "EdwardsCurveSpec": "eccoxide_tpu_torch.curves.edwards:EdwardsCurve",
        **{f"EdwardsCurveSpec.{m}": f"eccoxide_tpu_torch.curves.edwards:EdwardsCurve.{m}"
           for m in _ED_SAME},
        "EdwardsCurveSpec.double_b": _np("`ed_double` in `ops/csrc/group.cu` (`ops/group.py`)"),
        "EdwardsCurveSpec.add_b": _np("`ed_add` in `ops/csrc/group.cu` (`ops/group.py`)"),
        "EdwardsCurveSpec.add_mixed_b": _np("`ed_add_mixed`, the mixed mode of `ed_add` in "
                                            "`ops/csrc/group.cu` (`ops/group.py`)"),
    }),
    **_keyed("curves/montgomery.py", _same("curves.montgomery", (
        "MontgomeryCurveSpec", "MontgomeryCurveSpec.a24", "ladder"))),
    **_keyed("curves/ristretto255.py", {
        **_same("curves.ristretto255", (
            "sqrt_ratio_m1", "compress", "decompress", "eq", "elligator", "from_uniform_bytes",
            "mul_base", "FQ", "P", "SQRT_M1", "D", "SQRT_AD_MINUS_ONE", "INVSQRT_A_MINUS_D",
            "ONE_MINUS_D_SQ", "D_MINUS_ONE_SQ", "add", "double", "neg", "identity", "generator",
            "scalar_mul")),
        "ED": "eccoxide_tpu_torch.curves.curve25519:EDWARDS",
    }),
    **_keyed("curves/sec2.py", _same("curves.sec2", ("get_curve", "FIAT_TIER", "SMALL_TIER",
                                                     "ALL"))),
    **_keyed("curves/weierstrass.py", {
        **_same("curves.weierstrass", ("ProjPoint", "WeierstrassCurveSpec")),
        **_same("curves.weierstrass", _W_SAME, "WeierstrassCurveSpec."),
        "WeierstrassCurveSpec.add_b": _np("`WeierstrassCurveSpec.add` in `curves/weierstrass.py` "
                                          "(RCB15, its products batched over a stacked axis)"),
        "WeierstrassCurveSpec.double_b": _np("`WeierstrassCurveSpec.double` in "
                                             "`curves/weierstrass.py` (RCB15, batched products)"),
    }),
    **_keyed("field.py", {
        "Field": "eccoxide_tpu_torch.field_sec2:Field",
        **_same("field_sec2", _FIELD_SAME, "Field."),
        # an instance attribute of field_sec2.Field; a class attribute of FQ's
        "Field.n_bytes": "eccoxide_tpu_torch.field:Fe25519.n_bytes",
        "Field.from_mont": "eccoxide_tpu_torch.field:MontScalarField.from_mont",
        "Field.solinas_ok": _np("no Solinas special case: `field_sec2.py` folds every prime "
                                "by its fold matrix (`_Format`), `field.py` FQ by 19"),
        "Field.reduce_wide": _np("the reduction of 13-bit product columns: `field_sec2.py` "
                                 "`Field.from_wide_bytes_le` and `reduce_wide_bytes_le` "
                                 "reduce wide values through the fold matrix"),
        "Field.fused": _np(_FUSED),
        "FusedView": _np(_FUSED),
        **{f"Field.{m}": _np(_B_LIST) for m in _B_OPS},
        **{f"FusedView.{m}": _np(_FUSED) for m in _FUSED_OPS},
    }),
    **_keyed("limbs.py", {
        **_same("limbs", ("int_to_limbs", "limbs_to_ints", "ints_to_limbs")),
        "bytes_to_limbs_le": "eccoxide_tpu_torch.limbs:bytes_to_limbs",
        "limbs_to_bytes_le": "eccoxide_tpu_torch.limbs:limbs_to_bytes",
        "bytes_le_to_limbs": "eccoxide_tpu_torch.limbs:bytes_to_limbs",
    }),
    **_keyed("ops/pallas_group.py", {
        "pallas_add": "eccoxide_tpu_torch.ops.group:ed_add",
        "pallas_double": "eccoxide_tpu_torch.ops.group:ed_double",
        "pallas_pow": "eccoxide_tpu_torch.ops.group:pow_const_kernel",
        "PallasGroup": _np(_PALLAS),
        **{f"PallasGroup.{m}": _np(_PALLAS) for m in ("identity", "add", "double", "neg", "select")},
        **{n: _np("the Pallas kernels' lane tiling (widths padded to blocks of 512 lanes): "
                  "the wrappers of `ops/group.py` launch the CUDA kernels on any width, "
                  "a thread a lane") for n in ("LANE", "BLOCK")},
    }),
    **_keyed("ops/sha512.py", _same("ops.sha512", ("sha512_batch",))),
    **_keyed("oracle/curve.py", {
        "inv": _np("Python's built-in pow(x, -1, p), which `oracle.py` and "
                   "`params/_intcurve.py` call in place"),
        **_same("oracle", ("WCurve",)),
        **_same("oracle", ("on_curve", "add", "mul", "mul_base"), "WCurve."),
        **_same("params._intcurve", ("ECurve",)),
        **_same("params._intcurve", ("on_curve", "add", "mul", "mul_base"), "ECurve."),
        "mont_ladder": "eccoxide_tpu_torch.oracle:_ladder",
    }),
    **_keyed("oracle/ed25519.py", _same("oracle", ("public_key", "sign", "verify", "P", "L",
                                                   "D", "G"))),
    **_keyed("oracle/ristretto.py", {
        **_same("oracle", ("P", "D", "SQRT_M1", "ONE_MINUS_D_SQ", "D_MINUS_ONE_SQ",
                           "SQRT_AD_MINUS_ONE", "INVSQRT_A_MINUS_D")),
        "BASE": "eccoxide_tpu_torch.oracle:RISTRETTO_BASE",
        "IDENT": "eccoxide_tpu_torch.oracle:RISTRETTO_IDENTITY",
        "mul": "eccoxide_tpu_torch.oracle:ristretto_mul",
        **{n: f"eccoxide_tpu_torch.oracle:ristretto_{n}" for n in (
            "sqrt_ratio_m1", "compress", "decompress", "eq", "elligator", "from_uniform_bytes")},
    }),
    **_keyed("parallel/batch_verify.py", _same("parallel.batch_verify",
                                               ("make_sharded_verify", "shard_batch"))),
    **_keyed("parallel/msm.py", _same("parallel.msm", (
        "msm_local", "make_sharded_msm", "msm_local_window_sums", "msm_local_window_sums_prefix",
        "msm_local_prefix", "msm_multi_prefix", "msm_sharded_example"))),
    **_keyed("params/comb.py", {
        "EdwardsComb": "eccoxide_tpu_torch.params.comb:edwards_comb",
        "EdwardsComb.tables": "eccoxide_tpu_torch.params.comb:comb_tables",
        "EdwardsComb.mul_base": "eccoxide_tpu_torch.params.comb:mul_base",
        "get_comb": "eccoxide_tpu_torch.params.comb:edwards_comb",
        **_same("params.comb", ("WeierstrassComb", "WeierstrassComb.tables",
                                "WeierstrassComb.mul_base", "edwards_byte_table",
                                "get_weierstrass_comb")),
    }),
    **_keyed("params/sec2_params.py", _same("params.sec2_params", ("CURVES",))),
    **_keyed("protocol/api.py", _same("protocol.api", (
        "X25519SharedSecret", "X25519SharedSecret.was_contributory", "X25519PublicKey",
        "X25519SecretKey", "X25519SecretKey.public_key", "X25519SecretKey.exchange",
        "X448SharedSecret", "X448SharedSecret.was_contributory", "X448PublicKey",
        "X448SecretKey", "X448SecretKey.public_key", "X448SecretKey.exchange",
        "Ed25519PublicKey", "Ed25519PublicKey.verify", "Ed25519SecretKey",
        "Ed25519SecretKey.public_key", "Ed25519SecretKey.sign", "Ed25519Keypair",
        "Ed25519Keypair.sign", "Ed25519Keypair.verify"))),
    **_keyed("protocol/ed25519.py", {
        "sha512_batch_host": "eccoxide_tpu_torch.ops.sha512:sha512_batch",
        "windows_from_bytes_le": "eccoxide_tpu_torch.limbs:windows_from_bytes_le",
        "device_tables": "eccoxide_tpu_torch.protocol.ed25519:SignTables",
        "device_tables_verify": "eccoxide_tpu_torch.protocol.ed25519:VerifyTables",
        "FQ": "eccoxide_tpu_torch.curves.curve25519:FQ",
        **_same("protocol.ed25519", (
            "FL", "ED", "clamp_scalar_bytes", "scalar_mul_base", "scalar_mul", "sign_core", "r_point_core",
            "public_key_core", "verify_core", "double_scalar_mul_base", "expand_secret_host",
            "public_keys_host", "sign_with_expanded_host", "sign_host", "verify_host")),
    }),
    **_keyed("protocol/ed25519_batch.py", _same("protocol.ed25519_batch", (
        "rlc_verify_core", "sample_z", "verify_batch_host", "FL", "FQ", "ED", "Z_BYTES"))),
    **_keyed("protocol/x25519.py", _same("protocol.x25519", (
        "clamp", "x25519", "x25519_base", "was_contributory", "x25519_host", "x25519_base_host"))),
    **_keyed("protocol/x448.py", _same("protocol.x448", (
        "clamp", "x448", "x448_base", "was_contributory", "x448_host", "x448_base_host"))),
    **{f"__graft_entry__.py:{n}": f"eccoxide_tpu_torch.entry:{n}"
       for n in ("entry", "dryrun_multichip", "weak_scaling")},
    # a script's `if __name__ == "__main__":` block: the port module's main,
    # which its own block runs (python -m eccoxide_tpu_torch.<module>)
    "__graft_entry__.py:__main__": "eccoxide_tpu_torch.entry:main",
    "bench.py:__main__": "eccoxide_tpu_torch.bench:main",
    "bench_suite.py:__main__": "eccoxide_tpu_torch.bench_suite:main",
    # the measurement scripts: every def, private ones too
    "bench.py:_setup_jax": _np("the JAX compile cache: the port compiles its kernels once "
                               "into `eccoxide_tpu_torch/_build/` (`ops/build.py`, on first "
                               "use), where the ladder's later children find them"),
    **{f"bench.py:{n}": f"eccoxide_tpu_torch.bench:{n}" for n in (
        "_chain_time", "run_verify", "run_rlc", "run_x25519", "run_fieldmul", "_child", "_try",
        "main", "CHILD_MODES")},
    # the directory that compiled code outlives a process in: JAX's compile
    # cache there, the port's kernel libraries here (ops/build.py)
    "bench.py:CACHE_DIR": "eccoxide_tpu_torch.ops.build:BUILD_DIR",
    "bench.py:TARGET_PER_CHIP": _np("a throughput target per TPU chip, the divisor of the JAX "
                                    "record's `vs_baseline`: the records of `bench.py` leave "
                                    "that key out and name the card they ran on"),
    **{f"bench_suite.py:{n}": f"eccoxide_tpu_torch.bench_suite:{n}" for n in (
        "_fetch", "_bench", "main")},
    # the block_until_ready sync, which the JAX suite defines and never calls
    "bench_suite.py:jax_block": "eccoxide_tpu_torch.bench_suite:_fetch",
}


def _is_main_block(node) -> bool:
    return isinstance(node, ast.If) and ast.unparse(node.test) == "__name__ == '__main__'"


def _assigned(node) -> list:
    """The names a module-level assignment binds (tuple targets unpacked)."""
    targets = node.targets if isinstance(node, ast.Assign) else \
        [node.target] if isinstance(node, ast.AnnAssign) else []
    return [e.id for t in targets for e in (t.elts if isinstance(t, ast.Tuple) else [t])
            if isinstance(e, ast.Name)]


def _public_names():
    """(module-level names, method names) of the JAX package, as
    "<path relative to eccoxide_tpu/>:<name>" and ":<Class>.<method>"; a
    script's ``__main__`` block as "<script>:__main__"."""
    files = [(p, p.relative_to(ROOT / "eccoxide_tpu").as_posix())
             for p in sorted((ROOT / "eccoxide_tpu").rglob("*.py"))]
    files.append((ROOT / "__graft_entry__.py", "__graft_entry__.py"))
    scripts = ("bench.py", "bench_suite.py")
    files += [(ROOT / name, name) for name in scripts]
    top, methods = set(), set()
    for path, rel in files:
        for node in ast.parse(path.read_text()).body:
            if _is_main_block(node):
                top.add(f"{rel}:__main__")
            top |= {f"{rel}:{n}" for n in _assigned(node)
                    if not n.startswith("_") or n == "__version__"}
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) \
                    and (not node.name.startswith("_") or rel in scripts):
                top.add(f"{rel}:{node.name}")
                if isinstance(node, ast.ClassDef):
                    methods |= {f"{rel}:{node.name}.{m.name}" for m in node.body
                                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                                and not m.name.startswith("_")}
    return top, methods


def test_every_public_name_has_an_entry():
    top, methods = _public_names()
    assert (len(top), len(methods)) == (179, 122)
    assert sorted(n for n in top if n.endswith(":__main__")) == [
        "__graft_entry__.py:__main__", "bench.py:__main__", "bench_suite.py:__main__"]
    assert set(COUNTERPARTS) == top | methods, (
        sorted(top | methods - set(COUNTERPARTS)), sorted(set(COUNTERPARTS) - top - methods))


def test_every_counterpart_resolves_and_every_reason_names_port_code():
    not_ported = []
    for name, target in COUNTERPARTS.items():
        if isinstance(target, tuple):
            kind, reason = target
            assert kind == "not ported", name
            files = re.findall(r"[\w/]+\.(?:py|cu|cuh)\b", reason)
            assert files and all((PORT / f).is_file() or (PORT / "ops" / "csrc" / f).is_file()
                                 for f in files), (name, reason)
            not_ported.append(name)
            continue
        module, _, attr = target.partition(":")
        assert module.split(".")[0] == "eccoxide_tpu_torch", (name, target)
        mod = obj = importlib.import_module(module)
        for part in attr.split("."):
            obj = getattr(obj, part)
        if name.endswith(":__main__"):
            assert attr == "main" and callable(obj), (name, target)
            tree = ast.parse(pathlib.Path(mod.__file__).read_text())
            assert any(_is_main_block(node) for node in tree.body), (name, target)
    assert len(not_ported) == 42
