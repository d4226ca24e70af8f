#!/usr/bin/env python3
"""How often a seeded header token names a word the generator's tokenizer
had encoded before (a word the hash tokenizer's instance-wide reverse map
would decode), on the card.

It builds ``configs/production.yaml``'s pipeline as ``chip_smoke.py``'s
``profiles`` phase does (seeded large-v3 and llama-3.2-3b), ingests the
phase's three spoken files with ``ingest_batch`` and, for each header wave,
prints its tokens, distinct ids, the ids the tokenizer knew at the wave
("known") and the ids it learned only afterwards ("later"). The wave's key
is salted by Python's string hash, so run it under several
``PYTHONHASHSEED`` values for independent draws:

    for s in 11 12 13 14; do PYTHONHASHSEED=$s python3 \\
        scripts/probe_header_history.py; done
"""

import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> None:
    import chip_smoke as cs
    from audio_rag_tpu_torch.ops import kernels as K

    K.build(verbose=False)
    with tempfile.TemporaryDirectory() as tmp:
        rag = cs.production_rag("cuda", Path(tmp), None)
        files = cs.profile_files(Path(tmp))
        gen = rag.generator.inner
        waves = []
        orig = gen.generate_batch

        def spy(prompts, **kw):
            out = orig(prompts, **kw)
            waves.append((set(gen._tok._reverse),
                          [i for row in gen.last_token_ids for i in row]))
            return out

        gen.generate_batch = spy
        rag.ingest_batch(files, collection="probe")
        final = set(gen._tok._reverse)
        print("PROBE", json.dumps([
            {"tokens": len(ids), "distinct": len(set(ids)),
             "known": sum(i in known for i in ids),
             "later": sum(i in final and i not in known for i in ids)}
            for known, ids in waves]), flush=True)
        rag.unload_all()


if __name__ == "__main__":
    main()
