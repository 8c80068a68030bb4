"""End-to-end serving on the PyTorch port: batched prefill and greedy
decode against the party-sharded KV cache (the counterpart of
``examples/serve_lm.py``), on a reduced model.  Defaults to the reduced
qwen3-moe (4 experts top-2) on the CPU; ``--device cuda`` runs it on the
card::

    PYTHONPATH=src python examples/serve_lm_torch.py
    PYTHONPATH=src python examples/serve_lm_torch.py --arch gemma3_4b \\
        --model-parallel 4 --device cuda
    PYTHONPATH=src python examples/serve_lm_torch.py \\
        --arch jamba_v0_1_52b          # the reduced period stack (jamba)
    PYTHONPATH=src python examples/serve_lm_torch.py \
        --arch whisper_tiny            # the reduced encoder-decoder
    PYTHONPATH=src python examples/serve_lm_torch.py \
        --arch pixtral_12b             # 8 patches + 24 text tokens
"""
import argparse

from repro_torch.launch.serve import serve


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_moe_30b_a3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--model-parallel", type=int, default=2)
    ap.add_argument("--device", default="cpu")
    a = ap.parse_args()
    res = serve(a.arch, a.batch, a.prompt_len, a.gen_tokens, reduced=True,
                model_parallel=a.model_parallel, device=a.device)
    assert res.tokens.shape == (a.batch, a.gen_tokens)
    print(f"prefill {a.batch}x{a.prompt_len} in {res.prefill_seconds:.2f}s; "
          f"{len(res.step_seconds)} decode steps; first row: "
          f"{res.tokens[0].tolist()}")


if __name__ == "__main__":
    main()
