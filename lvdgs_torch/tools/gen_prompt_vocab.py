"""Generate the packaged prompt-lexicon WordPiece vocab for GroundingDINO.

The real pipeline tokenizes with bert-base-uncased's vocab.txt, which is not
in the repo. Detection over the SLAM system's own prompt surface does not
need the full 30,522-entry vocab: every caption the system emits comes from
ScenePromptManager.SCENES, COCO_DYNAMIC_CLASSES and user scene overrides, a
closed lexicon. This script derives a compact vocab that tokenizes that
lexicon word-level and any other ASCII word char-level (no [UNK] for normal
text), and writes it to lvdgs_torch/models/groundingdino/assets/prompt_vocab.txt
(or --out).

Its ids do not match bert-base-uncased: pretrained weights need the real
vocab.txt (pass vocab_path, or put vocab.txt next to the checkpoint). The
packaged vocab keeps the text pipeline exact and deterministic for
architecture runs, tests and weights trained on it.

Run: python -m lvdgs_torch.tools.gen_prompt_vocab  (idempotent; its output is checked in)
"""
import argparse
import os
import string

from lvdgs_torch.perception.dynamic_filter import COCO_DYNAMIC_CLASSES
from lvdgs_torch.perception.masking import ScenePromptManager

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "models", "groundingdino", "assets", "prompt_vocab.txt")

# words of the prompts and tools beyond the scene table
EXTRA_WORDS = [
    "ground", "sky", "sidewalk", "vehicle", "moving", "parked", "object",
    "dynamic", "static", "wheel", "window", "rider", "child", "adult",
    "traffic", "light", "crowd", "shadow",
]


def build_vocab() -> list:
    words = set()
    for scene in ScenePromptManager.SCENES.values():
        for phrase_list in scene.values():
            for phrase in phrase_list:
                words.update(phrase.lower().split())
    words.update(w.lower() for w in COCO_DYNAMIC_CLASSES)
    words.update(EXTRA_WORDS)

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "."]
    # char-level base and continuations: any ASCII word tokenizes without [UNK]
    chars = list(string.ascii_lowercase) + list(string.digits) + ["-", "'"]
    vocab += chars
    vocab += ["##" + c for c in chars]
    # common English suffix pieces, better than char continuations
    vocab += ["##s", "##ing", "##ed", "##er", "##es"]
    vocab += sorted(words)
    return list(dict.fromkeys(vocab))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT, help="where to write the vocab (default: the packaged asset)")
    args = ap.parse_args(argv)
    vocab = build_vocab()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    print(f"wrote {len(vocab)} tokens -> {args.out}")


if __name__ == "__main__":
    main()
