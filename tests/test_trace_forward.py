"""bench.trace_forward's attribution of device kernels to model scopes:
HLO instruction name -> op_name metadata -> named scope."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qmann_tpu.bench.trace_forward import SCOPES, hlo_op_names, scope_of
from qmann_tpu.config import QmannConfig
from qmann_tpu.data import DataDims
from qmann_tpu.models import memn2n

_HLO = '''
  %fusion.235 = f32[1000,60]{1,0} fusion(%p0, %p1), kind=kLoop, calls=%fc, metadata={op_name="jit(infer_scan)/while/body/closed_call/hop_chain/jit(_where)/select_n" stack_frame_id=3}
  ROOT %gemm_fusion_dot = f32[1000,10,360]{2,1,0} fusion(%a, %b), kind=kCustom, metadata={op_name="jit(infer_scan)/while/body/closed_call/embed/dot_general"}
  %copy-start.1 = f32[8]{0} copy-start(%x), metadata={op_name="jit(f)/hop_chain/output/dot_general"}
  %param.3 = f32[8]{0} parameter(3)
'''


def test_hlo_op_names_keys_both_spellings():
    names = hlo_op_names(_HLO)
    assert names["fusion.235"].endswith("hop_chain/jit(_where)/select_n")
    assert names["fusion_235"] == names["fusion.235"]
    assert names["gemm_fusion_dot"].endswith("embed/dot_general")
    assert names["copy_start_1"] == names["copy-start.1"]
    assert "param.3" not in names


@pytest.mark.parametrize("op_name,scope", [
    ("jit(f)/while/body/closed_call/hop_chain/select_n", "hop_chain"),
    ("jit(f)/hop_chain/output/dot_general", "output"),
    ("jit(f)/while/body/embed/convert_element_type", "embed"),
    ("jit(f)/while/body/argmax_last/reduce", "other"),
    ("jit(f)/embedding_like/dot_general", "other"),
    ("", "other"),
])
def test_scope_of(op_name, scope):
    assert scope_of(op_name) == scope


def test_serving_forward_carries_the_scopes():
    """The prepared serving forward names every scope the reduction
    reads, so its compiled HLO attributes kernels to all three."""
    cfg = QmannConfig(dim_emb=8, verbose=False)
    dims = DataDims(dim_dict=12, max_line=4, max_word=3, dim_word=4,
                    dim_input=16)
    params = memn2n.init_params(cfg, dims, jax.random.PRNGKey(0))
    prep = memn2n.prepare_inference(params, cfg, max_count=4.0,
                                    max_rowsum=4.0)
    assert prep.fast
    mem = jnp.asarray(np.ones((2, 4, 16), np.float32))
    que = jnp.asarray(np.ones((2, 16), np.float32))
    mask = jnp.ones((2, 4), bool)
    hlo = jax.jit(lambda m, q, k: memn2n.forward_prepared(
        prep, m, q, k, cfg).logits).lower(mem, que, mask).compile().as_text()
    found = {scope_of(n) for n in hlo_op_names(hlo).values()}
    assert set(SCOPES) <= found
