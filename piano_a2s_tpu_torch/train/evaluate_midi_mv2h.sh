#!/usr/bin/env bash
# MV2H wrapper: convert both MIDIs with the MV2H Converter, then score.
# Same contract as the reference tool wrapper. Requires Java + the MV2H
# jar/classes directory passed as the third argument.

if [ "$#" -ne 3 ]; then
    echo "USAGE: evaluate_midi_mv2h.sh ref.mid transcription.mid MV2H_path"
    exit 1
fi

java -cp "$3" mv2h.tools.Converter -i "$1" >"$1.conv.txt"
java -cp "$3" mv2h.tools.Converter -i "$2" >"$2.conv.txt"
java -cp "$3" mv2h.Main -g "$1.conv.txt" -t "$2.conv.txt" -a
rm -f "$1.conv.txt" "$2.conv.txt"
