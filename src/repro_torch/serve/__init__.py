from repro_torch.serve.kv_quant import (QuantKVCache, quantize_kv,
                                        dequantize_kv,
                                        quant_cache_update_decode,
                                        attention_with_quant_cache)
