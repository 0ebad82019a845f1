"""The port's function-variable precompute against the JAX package's.

`precompute_fn_values` (ops/fnvars.py) resolves every function slot of a
rules file per document through the CPU evaluator's scopes. On both
packages it must give the same slot keys, the same per-document results
(shared slots as [PV], per-origin slots as {origin path: [PV]}, equal as
plain values with their paths) and the same error set. The cases mirror
the rule texts and documents of tests/test_fn_lowering.py: chained and
rule-body lets, shadowing across when-blocks, per-origin calls in type
blocks, nested blocks, when-blocks and filters, the when-guard that
protects a call, cross-scope variables and their UnResolved route, the
slash-key origin collision, function errors, and `now`/`parse_char`,
which stay host rules. `canonical_names.guard` and the port's
FNVAR_RULES workload close the list.
"""

import pathlib

import numpy as np
import pytest
import yaml

from guard_tpu.core.parser import parse_rules_file as j_parse
from guard_tpu.core.values import from_plain as j_from_plain
from guard_tpu.ops.fnvars import precompute_fn_values as j_precompute
from guard_tpu_torch.core.parser import parse_rules_file as t_parse
from guard_tpu_torch.core.values import from_plain as t_from_plain
from guard_tpu_torch.ops.fnvars import precompute_fn_values as t_precompute
from guard_tpu_torch.workloads import FNVAR_RULES, make_fnvar_template
from test_torch_functions import to_plain

ROOT = pathlib.Path(__file__).resolve().parent.parent
CANONICAL = ROOT / "examples" / "rules" / "naming" / "canonical_names.guard"

# (name, rules text, documents), after tests/test_fn_lowering.py
FN_CASES = [('to_upper_lower_eq_and_regex',
  '\n'
  'let upper = to_upper(Resources.*.Name)\n'
  'let lower = to_lower(Resources.*.Name)\n'
  '\n'
  'rule has_prod when Resources exists {\n'
  '    some %upper == /PROD/\n'
  '}\n'
  'rule all_lower_lc when Resources exists {\n'
  '    %lower == /^[a-z0-9-]+$/\n'
  '}\n'
  'rule upper_exact when Resources exists {\n'
  "    some %upper == 'PROD-LOGS'\n"
  '}\n',
  [{'Resources': {'a': {'Name': 'Prod-Logs',
                        'Size': '42',
                        'Flag': 'true',
                        'Blob': '{"x": 1, "y": [2, 3]}',
                        'When': '2024-01-02T03:04:05Z'},
                  'b': {'Name': 'dev-scratch',
                        'Size': '7',
                        'Flag': 'false',
                        'Blob': '{"x": 9}',
                        'When': '2030-06-01T00:00:00Z'}}},
   {'Resources': {'a': {'Name': 'QA-Box',
                        'Size': '100.5',
                        'Flag': 'true',
                        'Blob': '[1, 2]',
                        'When': '1999-12-31T23:59:59Z'}}},
   {'Other': 1}]),
 ('parse_int_float_bool_ordering',
  '\n'
  'let sizes = parse_float(Resources.*.Size)\n'
  'let flags = parse_boolean(Resources.*.Flag)\n'
  '\n'
  'rule big when Resources exists { some %sizes > 40.0 }\n'
  'rule all_small when Resources exists { %sizes < 1000.0 }\n'
  'rule any_on when Resources exists { some %flags == true }\n',
  [{'Resources': {'a': {'Name': 'Prod-Logs',
                        'Size': '42',
                        'Flag': 'true',
                        'Blob': '{"x": 1, "y": [2, 3]}',
                        'When': '2024-01-02T03:04:05Z'},
                  'b': {'Name': 'dev-scratch',
                        'Size': '7',
                        'Flag': 'false',
                        'Blob': '{"x": 9}',
                        'When': '2030-06-01T00:00:00Z'}}},
   {'Resources': {'a': {'Name': 'QA-Box',
                        'Size': '100.5',
                        'Flag': 'true',
                        'Blob': '[1, 2]',
                        'When': '1999-12-31T23:59:59Z'}}},
   {'Other': 1}]),
 ('join_and_substring',
  '\n'
  'let names = Resources.*.Name\n'
  'let n = count(%names)\n'
  "let joined = join(%names, ',')\n"
  'let prefix = substring(%names, 0, 3)\n'
  '\n'
  'rule joined_has_comma when %n >= 2 { %joined == /,/ }\n'
  'rule prefix_checks when Resources exists { some %prefix == /^(Pro|dev|QA-)$/ '
  '}\n',
  [{'Resources': {'a': {'Name': 'Prod-Logs',
                        'Size': '42',
                        'Flag': 'true',
                        'Blob': '{"x": 1, "y": [2, 3]}',
                        'When': '2024-01-02T03:04:05Z'},
                  'b': {'Name': 'dev-scratch',
                        'Size': '7',
                        'Flag': 'false',
                        'Blob': '{"x": 9}',
                        'When': '2030-06-01T00:00:00Z'}}},
   {'Resources': {'a': {'Name': 'QA-Box',
                        'Size': '100.5',
                        'Flag': 'true',
                        'Blob': '[1, 2]',
                        'When': '1999-12-31T23:59:59Z'}}}]),
 ('regex_replace_and_url_decode',
  '\n'
  "let renamed = regex_replace(Resources.*.Name, '^(\\w+)-(\\w+)$', '${2}_${1}')\n"
  '\n'
  "rule swapped when Resources exists { some %renamed == 'Logs_Prod' }\n",
  [{'Resources': {'a': {'Name': 'Prod-Logs',
                        'Size': '42',
                        'Flag': 'true',
                        'Blob': '{"x": 1, "y": [2, 3]}',
                        'When': '2024-01-02T03:04:05Z'},
                  'b': {'Name': 'dev-scratch',
                        'Size': '7',
                        'Flag': 'false',
                        'Blob': '{"x": 9}',
                        'When': '2030-06-01T00:00:00Z'}}},
   {'Resources': {'a': {'Name': 'QA-Box',
                        'Size': '100.5',
                        'Flag': 'true',
                        'Blob': '[1, 2]',
                        'When': '1999-12-31T23:59:59Z'}}},
   {'Other': 1}]),
 ('json_parse_subtree_walk',
  '\n'
  'let parsed = json_parse(Resources.*.Blob)\n'
  '\n'
  'rule x_is_one when Resources exists { some %parsed.x == 1 }\n'
  'rule y_second when Resources exists { some %parsed.y[1] == 3 }\n',
  [{'Resources': {'a': {'Name': 'Prod-Logs',
                        'Size': '42',
                        'Flag': 'true',
                        'Blob': '{"x": 1, "y": [2, 3]}',
                        'When': '2024-01-02T03:04:05Z'},
                  'b': {'Name': 'dev-scratch',
                        'Size': '7',
                        'Flag': 'false',
                        'Blob': '{"x": 9}',
                        'When': '2030-06-01T00:00:00Z'}}},
   {'Resources': {'a': {'Name': 'QA-Box',
                        'Size': '100.5',
                        'Flag': 'true',
                        'Blob': '[1, 2]',
                        'When': '1999-12-31T23:59:59Z'}}},
   {'Other': 1}]),
 ('parse_epoch_range',
  '\n'
  'let when = parse_epoch(Resources.*.When)\n'
  '\n'
  'rule before_2026 when Resources exists {\n'
  '    some %when < 1767225600\n'
  '}\n',
  [{'Resources': {'a': {'Name': 'Prod-Logs',
                        'Size': '42',
                        'Flag': 'true',
                        'Blob': '{"x": 1, "y": [2, 3]}',
                        'When': '2024-01-02T03:04:05Z'},
                  'b': {'Name': 'dev-scratch',
                        'Size': '7',
                        'Flag': 'false',
                        'Blob': '{"x": 9}',
                        'When': '2030-06-01T00:00:00Z'}}},
   {'Resources': {'a': {'Name': 'QA-Box',
                        'Size': '100.5',
                        'Flag': 'true',
                        'Blob': '[1, 2]',
                        'When': '1999-12-31T23:59:59Z'}}},
   {'Other': 1}]),
 ('chained_function_lets',
  '\n'
  'let upper = to_upper(Resources.*.Name)\n'
  "let swapped = regex_replace(%upper, '^(\\w+)-(\\w+)$', '$2/$1')\n"
  '\n'
  "rule chained when Resources exists { some %swapped == 'LOGS/PROD' }\n",
  [{'Resources': {'a': {'Name': 'Prod-Logs',
                        'Size': '42',
                        'Flag': 'true',
                        'Blob': '{"x": 1, "y": [2, 3]}',
                        'When': '2024-01-02T03:04:05Z'},
                  'b': {'Name': 'dev-scratch',
                        'Size': '7',
                        'Flag': 'false',
                        'Blob': '{"x": 9}',
                        'When': '2030-06-01T00:00:00Z'}}},
   {'Resources': {'a': {'Name': 'QA-Box',
                        'Size': '100.5',
                        'Flag': 'true',
                        'Blob': '[1, 2]',
                        'When': '1999-12-31T23:59:59Z'}}},
   {'Other': 1}]),
 ('fn_var_inside_filter_broadcasts',
  '\n'
  'let upper = to_upper(Resources.*.Name)\n'
  '\n'
  'rule gated when Resources exists {\n'
  '    Resources.*[ Size exists ] {\n'
  '        some %upper == /PROD/\n'
  '        Size exists\n'
  '    }\n'
  '}\n',
  [{'Resources': {'a': {'Name': 'Prod-Logs',
                        'Size': '42',
                        'Flag': 'true',
                        'Blob': '{"x": 1, "y": [2, 3]}',
                        'When': '2024-01-02T03:04:05Z'},
                  'b': {'Name': 'dev-scratch',
                        'Size': '7',
                        'Flag': 'false',
                        'Blob': '{"x": 9}',
                        'When': '2030-06-01T00:00:00Z'}}},
   {'Resources': {'a': {'Name': 'QA-Box',
                        'Size': '100.5',
                        'Flag': 'true',
                        'Blob': '[1, 2]',
                        'When': '1999-12-31T23:59:59Z'}}},
   {'Other': 1}]),
 ('fn_var_as_query_rhs',
  '\n'
  'let upper = to_upper(Resources.*.Name)\n'
  '\n'
  'rule in_upper when Resources exists {\n'
  '    Resources.*.AllCaps IN %upper\n'
  '}\n',
  [{'Resources': {'a': {'Name': 'prod', 'AllCaps': 'PROD'}}},
   {'Resources': {'a': {'Name': 'prod', 'AllCaps': 'DEV'}}}]),
 ('fn_var_interpolation',
  '\n'
  'let keyname = to_lower(Settings.Key)\n'
  '\n'
  'rule has_key when Settings exists { Resources.%keyname exists }\n',
  [{'Settings': {'Key': 'ALPHA'}, 'Resources': {'alpha': 1}},
   {'Settings': {'Key': 'BETA'}, 'Resources': {'alpha': 1}}]),
 ('fn_var_empty_results',
  '\n'
  'let upper = to_upper(Resources.*.Missing)\n'
  '\n'
  'rule any_upper when Resources exists { %upper !empty }\n'
  'rule empty_upper when Resources exists { %upper empty }\n',
  [{'Resources': {'a': {'Name': 'Prod-Logs',
                        'Size': '42',
                        'Flag': 'true',
                        'Blob': '{"x": 1, "y": [2, 3]}',
                        'When': '2024-01-02T03:04:05Z'},
                  'b': {'Name': 'dev-scratch',
                        'Size': '7',
                        'Flag': 'false',
                        'Blob': '{"x": 9}',
                        'When': '2030-06-01T00:00:00Z'}}},
   {'Resources': {'a': {'Name': 'QA-Box',
                        'Size': '100.5',
                        'Flag': 'true',
                        'Blob': '[1, 2]',
                        'When': '1999-12-31T23:59:59Z'}}},
   {'Other': 1}]),
 ('now_and_parse_char_stay_host',
  '\n'
  'let t = now()\n'
  'let c = parse_char(Resources.*.Digit)\n'
  '\n'
  'rule time_ok when Resources exists { %t > 0 }\n'
  'rule char_ok when Resources exists { %c exists }\n',
  [{'Resources': {'a': {'Digit': '5'}}}, {'Resources': {'a': {'Digit': 'x'}}}]),
 ('excluded_transitively_through_var_refs',
  '\n'
  'let t = now()\n'
  'let u = to_upper(%t)\n'
  'let ok = to_upper(Resources.*.Name)\n'
  '\n'
  'rule r1 when Resources exists { %u exists }\n'
  'rule r2 when Resources exists { %ok exists }\n',
  [{'Resources': {'a': {'Name': 'prod'}}}, {'Other': 1}]),
 ('fn_error_doc_reported',
  '\n'
  'let n = parse_int(Resources.*.Size)\n'
  '\n'
  'rule ok when Resources exists { some %n >= 0 }\n',
  [{'Resources': {'a': {'Size': '42'}}},
   {'Resources': {'a': {'Size': 'not-a-number'}}}]),
 ('backend_cli_fn_parity',
  '\n'
  'let upper = to_upper(Resources.*.Name)\n'
  '\n'
  'rule named_prod when Resources exists { some %upper == /PROD/ }\n',
  [{'Resources': {'a': {'Name': 'prod-x'}}},
   {'Resources': {'a': {'Name': 'dev-x'}}}]),
 ('rule_body_function_lets',
  '\n'
  "let template = Resources.*[ Type == 'Svc' ]\n"
  '\n'
  'rule SOME_RULE when %template !empty {\n'
  '    let collection = %template.Collection.*\n'
  '    let res = join(%collection, ",")\n'
  '    %res == "a,b,c"\n'
  '}\n'
  '\n'
  'rule CONVERT when %template !empty {\n'
  '    let minv = parse_int(%template.Min)\n'
  '    %minv == 1\n'
  '    let lower = to_lower(%template.Name)\n'
  '    %lower == /^svc/\n'
  '}\n',
  [{'Resources': {'x': {'Type': 'Svc',
                        'Collection': {'p': 'a', 'q': 'b', 'r': 'c'},
                        'Min': '1',
                        'Name': 'SVC-MAIN'}}},
   {'Resources': {'x': {'Type': 'Svc',
                        'Collection': {'p': 'a'},
                        'Min': '2',
                        'Name': 'OTHER'}}},
   {'Resources': {'y': {'Type': 'Other'}}}]),
 ('rule_body_json_parse_block_walk',
  '\n'
  "let template = Resources.*[ Type == 'Svc' ]\n"
  '\n'
  'rule SOME_RULE when %template !empty {\n'
  '    let policy = %template.PolicyText\n'
  '    let res = json_parse(%policy)\n'
  '\n'
  '    %res !empty\n'
  '\n'
  '    %res.Statement[*] {\n'
  '        Effect == "Deny"\n'
  '        Resource == "arn:aws:s3:::s3-test-123/*"\n'
  '    }\n'
  '}\n',
  [{'Resources': {'x': {'Type': 'Svc',
                        'PolicyText': '{"Statement": [{"Effect": "Deny", '
                                      '"Resource": '
                                      '"arn:aws:s3:::s3-test-123/*"}]}'}}},
   {'Resources': {'x': {'Type': 'Svc',
                        'PolicyText': '{"Statement": [{"Effect": "Allow", '
                                      '"Resource": '
                                      '"arn:aws:s3:::s3-test-123/*"}]}'}}},
   {'Resources': {'y': {'Type': 'Other'}}}]),
 ('rule_body_fn_shadows_file_fn',
  '\n'
  'let name = to_upper(Settings.A)\n'
  '\n'
  'rule shadowed when Settings exists {\n'
  '    let name = to_upper(Settings.B)\n'
  "    some %name == 'BEE'\n"
  '}\n'
  'rule unshadowed when Settings exists {\n'
  "    some %name == 'AYE'\n"
  '}\n',
  [{'Settings': {'A': 'aye', 'B': 'bee'}}, {'Settings': {'A': 'bee', 'B': 'aye'}}]),
 ('inline_fn_rhs_clause',
  '\n'
  "let template = Resources.*[ Type == 'Svc' ]\n"
  '\n'
  'rule TEST_COLLECTION when %template !empty {\n'
  '    let collection = %template.Collection.*\n'
  '    let res = join(%collection, ",")\n'
  '    %res == "a,b"\n'
  '    "a,b" == join(%collection, ",")\n'
  '}\n',
  [{'Resources': {'x': {'Type': 'Svc', 'Collection': {'p': 'a', 'q': 'b'}}}},
   {'Resources': {'x': {'Type': 'Svc', 'Collection': {'p': 'z'}}}},
   {'Resources': {'y': {'Type': 'Other'}}}]),
 ('literal_map_head_vs_fn_rhs',
  '\n'
  "let template = Resources.*[ Type == 'Svc' ]\n"
  '\n'
  'let expected = {\n'
  '    "Principal": "*",\n'
  '    "Actions": ["s3*", "ec2*"]\n'
  '}\n'
  '\n'
  'rule SOME_RULE when %template !empty {\n'
  '    let policy = %template.Policy\n'
  '    let res = json_parse(%policy)\n'
  '\n'
  '    %expected == json_parse(%policy)\n'
  '    %res !empty\n'
  '    %res == %expected\n'
  '}\n',
  [{'Resources': {'x': {'Type': 'Svc',
                        'Policy': '{"Principal": "*", "Actions": ["s3*", '
                                  '"ec2*"]}'}}},
   {'Resources': {'x': {'Type': 'Svc',
                        'Policy': '{"Principal": "admin", "Actions": []}'}}},
   {'Resources': {'y': {'Type': 'Other'}}}]),
 ('parameterized_call_with_fn_args',
  '\n'
  'rule compare_number_of_buckets(expected) {\n'
  '    %expected == 2\n'
  '}\n'
  '\n'
  'rule compare_replaced(replaced, expected) {\n'
  '    %replaced == %expected\n'
  '}\n'
  '\n'
  "let buckets = Resources.*[ Type == 'Bucket' ]\n"
  '\n'
  'rule COMBINED when %buckets !empty {\n'
  '    compare_number_of_buckets(count(%buckets))\n'
  '}\n'
  '\n'
  'rule WITH_REGEX when %buckets exists {\n'
  '    let arn = %buckets.Arn\n'
  '    let expected = "aws/123/us-west-2"\n'
  '    compare_replaced(regex_replace(%arn, "^arn:(\\w+):(\\d+):([\\w0-9-]+)$", '
  '"${1}/${2}/${3}"), %expected)\n'
  '}\n',
  [{'Resources': {'a': {'Type': 'Bucket', 'Arn': 'arn:aws:123:us-west-2'},
                  'b': {'Type': 'Bucket', 'Arn': 'arn:aws:123:us-west-2'}}},
   {'Resources': {'a': {'Type': 'Bucket', 'Arn': 'arn:aws:999:eu-west-1'}}},
   {'Resources': {'y': {'Type': 'Other'}}}]),
 ('literal_head_walk_into_subtree',
  '\n'
  'let expected = { "a": {"b": [1, 2]} }\n'
  '\n'
  'rule walk when Resources exists {\n'
  '    %expected.a.b[1] == 2\n'
  '    %expected.a.b[0] == Resources.First\n'
  '}\n',
  [{'Resources': {'First': 1}}, {'Resources': {'First': 7}}]),
 ('literal_call_arg_as_callee_head',
  '\n'
  'rule compare_replaced(replaced, expected) {\n'
  '    %expected == %replaced\n'
  '}\n'
  '\n'
  "let svcs = Resources.*[ Type == 'Svc' ]\n"
  '\n'
  'rule CALLS when %svcs exists {\n'
  '    let arn = %svcs.Arn\n'
  '    compare_replaced(regex_replace(%arn, "^arn:(\\w+):(\\d+)$", "${1}/${2}"), '
  '"aws/123")\n'
  '}\n',
  [{'Resources': {'a': {'Type': 'Svc', 'Arn': 'arn:aws:123'}}},
   {'Resources': {'a': {'Type': 'Svc', 'Arn': 'arn:aws:999'}}},
   {'Resources': {'y': {'Type': 'Other'}}}]),
 ('same_fn_let_in_two_when_blocks',
  '\n'
  'rule r {\n'
  '    when Resources exists {\n'
  '        let u = to_upper(Resources.*.Name)\n'
  "        some %u == 'ALPHA'\n"
  '    }\n'
  '    when Outputs exists {\n'
  '        let u = to_upper(Outputs.*.Name)\n'
  "        some %u == 'BETA'\n"
  '    }\n'
  '}\n',
  [{'Resources': {'a': {'Name': 'alpha'}}, 'Outputs': {'o': {'Name': 'beta'}}},
   {'Resources': {'a': {'Name': 'alpha'}}},
   {'Outputs': {'o': {'Name': 'nope'}}},
   {'Other': 1}]),
 ('fn_let_shadows_file_let_across_when_blocks',
  '\n'
  'let u = to_upper(Resources.*.Kind)\n'
  '\n'
  "rule outer when Resources exists { some %u == 'FILE' }\n"
  'rule inner {\n'
  '    when Resources exists {\n'
  '        let u = to_lower(Resources.*.Name)\n'
  "        some %u == 'block'\n"
  '    }\n'
  '}\n',
  [{'Resources': {'a': {'Kind': 'file', 'Name': 'BLOCK'}}},
   {'Resources': {'a': {'Kind': 'other', 'Name': 'nope'}}}]),
 ('nested_when_blocks_same_name_three_bindings',
  '\n'
  'rule r {\n'
  '    let u = to_upper(Resources.*.Tag)\n'
  "    some %u == 'BODY'\n"
  '    when Resources exists {\n'
  '        let u = to_upper(Resources.*.Name)\n'
  "        some %u == 'WHEN1'\n"
  '        when Resources exists {\n'
  '            let u = to_lower(Resources.*.Name)\n'
  "            some %u == 'when2'\n"
  '        }\n'
  '    }\n'
  '}\n',
  [{'Resources': {'a': {'Tag': 'body', 'Name': 'When1'}}},
   {'Resources': {'a': {'Tag': 'body', 'Name': 'WHEN2'}}},
   {'Resources': {'a': {'Tag': 'x', 'Name': 'y'}}}]),
 ('per_origin_inline_call_in_block',
  '\n'
  'rule r when Resources exists {\n'
  '    Resources.* { Name == to_lower(Name) }\n'
  '}\n',
  [{'Resources': {'a': {'Name': 'abc',
                        'Limit': '10',
                        'Size': 5,
                        'Tags': ['x', 'y'],
                        'Type': 'A'},
                  'b': {'Name': 'DEF',
                        'Limit': '3',
                        'Size': 5,
                        'Tags': ['z'],
                        'Type': 'B'}}},
   {'Resources': {'a': {'Name': 'xyz',
                        'Limit': '100',
                        'Size': 1,
                        'Tags': [],
                        'Type': 'A'}}},
   {'Other': 1}]),
 ('per_origin_ordering_compare',
  '\n'
  'rule r when Resources exists {\n'
  '    Resources.* { Size < parse_int(Limit) }\n'
  '}\n',
  [{'Resources': {'a': {'Name': 'abc',
                        'Limit': '10',
                        'Size': 5,
                        'Tags': ['x', 'y'],
                        'Type': 'A'},
                  'b': {'Name': 'DEF',
                        'Limit': '3',
                        'Size': 5,
                        'Tags': ['z'],
                        'Type': 'B'}}},
   {'Resources': {'a': {'Name': 'xyz',
                        'Limit': '100',
                        'Size': 1,
                        'Tags': [],
                        'Type': 'A'}}},
   {'Other': 1}]),
 ('per_origin_in_type_block',
  '\n'
  'rule r when Resources exists {\n'
  '    AWS::X::Y {\n'
  '        Properties.Ref == to_upper(Properties.Base)\n'
  '    }\n'
  '}\n',
  [{'Resources': {'a': {'Type': 'AWS::X::Y',
                        'Properties': {'Ref': 'ONE', 'Base': 'one'}}}},
   {'Resources': {'a': {'Type': 'AWS::X::Y',
                        'Properties': {'Ref': 'one', 'Base': 'one'}}}},
   {'Resources': {'a': {'Type': 'Other',
                        'Properties': {'Ref': 'x', 'Base': 'y'}}}}]),
 ('per_origin_nested_blocks',
  '\n'
  'rule r when Groups exists {\n'
  '    Groups.* {\n'
  '        Members.* { Id == to_lower(Id) }\n'
  '    }\n'
  '}\n',
  [{'Groups': {'g1': {'Members': {'m1': {'Id': 'aa'}, 'm2': {'Id': 'BB'}}},
               'g2': {'Members': {'m3': {'Id': 'cc'}}}}},
   {'Groups': {'g1': {'Members': {'m1': {'Id': 'ok'}}}}},
   {'Other': 1}]),
 ('per_origin_when_block_and_vs_let',
  '\n'
  'rule r when Resources exists {\n'
  '    Resources.* {\n'
  "        when Type == 'A' {\n"
  '            let parts = Tags[*]\n'
  "            Name == join(%parts, ',')\n"
  '        }\n'
  '    }\n'
  '}\n',
  [{'Resources': {'a': {'Type': 'A', 'Name': 'x,y', 'Tags': ['x', 'y']},
                  'b': {'Type': 'A', 'Name': 'nope', 'Tags': ['z']}}},
   {'Resources': {'a': {'Type': 'B', 'Name': 'n', 'Tags': ['t']}}},
   {'Resources': {'a': {'Type': 'A', 'Name': 'z', 'Tags': ['z']}}}]),
 ('per_origin_in_membership',
  '\n'
  'rule r when Resources exists {\n'
  '    Resources.* { Name IN json_parse(Allowed) }\n'
  '}\n',
  [{'Resources': {'a': {'Name': 'x', 'Allowed': '["x", "y"]'},
                  'b': {'Name': 'q', 'Allowed': '["x", "y"]'}}},
   {'Resources': {'a': {'Name': 'y', 'Allowed': '["y"]'}}}]),
 ('per_origin_mixed_with_shared_expr',
  '\n'
  'let names = Resources.*.Name\n'
  "rule shared when Resources exists { 'abc,DEF' == join(%names, ',') }\n"
  'rule perorigin when Resources exists {\n'
  '    Resources.* { Name == to_upper(Name) }\n'
  '}\n',
  [{'Resources': {'a': {'Name': 'abc'}, 'b': {'Name': 'DEF'}}},
   {'Resources': {'a': {'Name': 'ABC'}}}]),
 ('per_origin_fn_error_doc_routes_to_oracle',
  '\n'
  'rule r when Resources exists {\n'
  '    Resources.* { Size < parse_int(Limit) }\n'
  '}\n',
  [{'Resources': {'a': {'Size': 1, 'Limit': '10'}}},
   {'Resources': {'a': {'Size': 1, 'Limit': 'oops'}}}]),
 ('per_origin_inside_filter_lowers',
  '\n'
  'rule r when Resources exists {\n'
  '    Resources.*[ Name == to_lower(Name) ] exists\n'
  '}\n',
  [{'Resources': {'a': {'Name': 'abc',
                        'Limit': '10',
                        'Size': 5,
                        'Tags': ['x', 'y'],
                        'Type': 'A'},
                  'b': {'Name': 'DEF',
                        'Limit': '3',
                        'Size': 5,
                        'Tags': ['z'],
                        'Type': 'B'}}},
   {'Resources': {'a': {'Name': 'xyz',
                        'Limit': '100',
                        'Size': 1,
                        'Tags': [],
                        'Type': 'A'}}},
   {'Other': 1}]),
 ('per_origin_when_guard_protects_call',
  '\n'
  'rule r when Resources exists {\n'
  '    Resources.* {\n'
  '        when Limit == /^[0-9]+$/ {\n'
  '            Size < parse_int(Limit)\n'
  '        }\n'
  '    }\n'
  '}\n',
  [{'Resources': {'a': {'Size': 1, 'Limit': '10'}}},
   {'Resources': {'a': {'Size': 1, 'Limit': 'oops'}}},
   {'Resources': {'a': {'Size': 9, 'Limit': '5'},
                  'b': {'Size': 1, 'Limit': 'not-a-number'}}}]),
 ('per_origin_root_lhs_makes_no_slot',
  '\n'
  'let heads = Resources.*\n'
  'rule r when Resources exists {\n'
  '    Resources.* { %heads.Name == to_lower(Name) }\n'
  '}\n',
  [{'Resources': {'a': {'Name': 'abc'}}}]),
 ('per_origin_slash_key_path_collision_routes_to_oracle',
  '\n'
  'rule r when Resources exists {\n'
  '    Resources.* { Name == to_lower(Name) }\n'
  '}\n',
  [{'Resources': {'x/Name': {'Name': 'ABC'}, 'x': {'Name': 'def'}}},
   {'Resources': {'a': {'Name': 'ABC'}}}]),
 ('cross_scope_var_rhs_in_filter',
  '\n'
  'rule r when Resources exists {\n'
  '    Resources.* {\n'
  '        let t = Type\n'
  '        Properties[ Kind == %t ] exists\n'
  '    }\n'
  '}\n',
  [{'Resources': {'a': {'Type': 'A',
                        'Properties': {'p1': {'Kind': 'A'}, 'p2': {'Kind': 'B'}}}}},
   {'Resources': {'a': {'Type': 'X', 'Properties': {'p1': {'Kind': 'A'}}}}},
   {'Resources': {'a': {'Type': 'A', 'Properties': {'p': {'Kind': 'A'}}},
                  'b': {'Type': 'B', 'Properties': {'p': {'Kind': 'A'}}}}},
   {'Other': 1}]),
 ('cross_scope_var_rhs_in_nested_block',
  '\n'
  'rule r when Groups exists {\n'
  '    Groups.* {\n'
  '        let gid = Id\n'
  '        Members.* { Owner == %gid }\n'
  '    }\n'
  '}\n',
  [{'Groups': {'g1': {'Id': 'g1x',
                      'Members': {'m1': {'Owner': 'g1x'}, 'm2': {'Owner': 'zz'}}},
               'g2': {'Id': 'g2x', 'Members': {'m': {'Owner': 'g2x'}}}}},
   {'Groups': {'g1': {'Id': 'q', 'Members': {'m': {'Owner': 'q'}}}}}]),
 ('cross_scope_var_ops_and_shadowing',
  '\n'
  'rule caps when Resources exists {\n'
  '    Resources.* {\n'
  '        let cap = Cap\n'
  '        Disks[ Size <= %cap ] !empty\n'
  '    }\n'
  '}\n'
  'rule shadow when Resources exists {\n'
  '    Resources.* {\n'
  '        let t = Outer\n'
  '        Props.* {\n'
  '            let t = Inner\n'
  '            Checks[ V == %t ] exists\n'
  '        }\n'
  '    }\n'
  '}\n',
  [{'Resources': {'a': {'Cap': 10,
                        'Disks': {'d1': {'Size': 5}, 'd2': {'Size': 50}},
                        'Outer': 'o',
                        'Props': {'p': {'Inner': 'i',
                                        'Checks': {'c': {'V': 'i'}}}}}}},
   {'Resources': {'a': {'Cap': 1,
                        'Disks': {'d': {'Size': 5}},
                        'Outer': 'o',
                        'Props': {'p': {'Inner': 'i',
                                        'Checks': {'c': {'V': 'o'}}}}}}}]),
 ('cross_scope_var_literal_binding',
  '\n'
  'rule r when Resources exists {\n'
  '    Resources.* {\n'
  "        let want = 'gold'\n"
  '        Tags[ Tier == %want ] exists\n'
  '    }\n'
  '}\n',
  [{'Resources': {'a': {'Tags': {'t': {'Tier': 'gold'}}}}},
   {'Resources': {'a': {'Tags': {'t': {'Tier': 'iron'}}}}}]),
 ('cross_scope_var_unresolved_routes_to_oracle',
  '\n'
  'rule r when Resources exists {\n'
  '    Resources.* {\n'
  '        let t = Type\n'
  '        Properties[ Kind == %t ] exists\n'
  '    }\n'
  '}\n',
  [{'Resources': {'a': {'Type': 'A', 'Properties': {'p': {'Kind': 'A'}}}}},
   {'Resources': {'a': {'Properties': {'p': {'Kind': 'A'}}}}}]),
 ('per_origin_call_inside_filter',
  '\n'
  'rule r when Resources exists {\n'
  '    Resources.*[ Name == to_lower(Name) ] exists\n'
  '}\n'
  'rule deep when Resources exists {\n'
  '    Resources.*.Tags[ Id == to_upper(Id) ] !empty\n'
  '}\n',
  [{'Resources': {'a': {'Name': 'abc', 'Tags': {'t': {'Id': 'XY'}}},
                  'b': {'Name': 'DEF', 'Tags': {'t': {'Id': 'zz'}}}}},
   {'Resources': {'a': {'Name': 'ZZZ', 'Tags': {'t': {'Id': 'A'}}}}},
   {'Other': 1}]),
 ('cross_scope_var_head_use_stays_host',
  '\n'
  'rule r when Resources exists {\n'
  '    Resources.* {\n'
  '        let t = Type\n'
  '        Properties { %t exists }\n'
  '    }\n'
  '}\n',
  [{'Resources': {'a': {'Type': 'A', 'Properties': {}}}}]),
 ('cross_scope_excluded_indirection_stays_host',
  '\n'
  'rule r when Resources exists {\n'
  '    Resources.* {\n'
  '        let a = parse_char(Code)\n'
  '        let t = %a\n'
  '        Props[ K == %t ] exists\n'
  '    }\n'
  '}\n',
  [{'Resources': {'x': {'Code': 'k', 'Props': {'p': {'K': 'k'}}}}}])]


def _canonical_case():
    spec = CANONICAL.parent / "tests" / "canonical_names_tests.yaml"
    docs = [c["input"] for c in yaml.safe_load(spec.read_text())]
    return ("canonical_names", CANONICAL.read_text(), docs)


def _fnvar_workload_case():
    rng = np.random.default_rng(23)
    docs = [make_fnvar_template(rng, i, exotic=i == 5) for i in range(48)]
    # a template with no Parameters: the inline call's argument is
    # missing, which regex_replace skips
    docs[7] = {"Resources": docs[7]["Resources"]}
    return ("fnvar_workload", FNVAR_RULES, docs)


CASES = FN_CASES + [_canonical_case(), _fnvar_workload_case()]
IDS = [c[0] for c in CASES]


def _plain_values(per_doc):
    out = []
    for vals in per_doc:
        row = {}
        for key, v in vals.items():
            if isinstance(v, dict):
                row[key] = {o: [to_plain(pv) for pv in pvs] for o, pvs in v.items()}
            else:
                row[key] = [to_plain(pv) for pv in v]
        out.append(row)
    return out


def precompute_both(text, docs):
    jk, jv, je = j_precompute(j_parse(text, "fn.guard"), [j_from_plain(d) for d in docs])
    tk, tv, te = t_precompute(t_parse(text, "fn.guard"), [t_from_plain(d) for d in docs])
    return (jk, _plain_values(jv), je), (tk, _plain_values(tv), te)


@pytest.mark.parametrize("name,text,docs", CASES, ids=IDS)
def test_precompute_fn_values_matches_jax(name, text, docs):
    want, got = precompute_both(text, docs)
    assert got[0] == want[0]  # slot keys, in encode order
    assert got[2] == want[2]  # error set
    for di, (g, w) in enumerate(zip(got[1], want[1])):
        assert g == w, f"document {di}"


def _case(name):
    return next(c for c in CASES if c[0] == name)


@pytest.mark.parametrize("name,errors", [
    ("fn_error_doc_reported", {1}),
    ("per_origin_fn_error_doc_routes_to_oracle", {1}),
    ("cross_scope_var_unresolved_routes_to_oracle", {1}),
    ("per_origin_when_guard_protects_call", set()),
    ("per_origin_slash_key_path_collision_routes_to_oracle", set()),
    ("fnvar_workload", set()),
])
def test_error_sets_are_the_expected_ones(name, errors):
    _n, text, docs = _case(name)
    _want, got = precompute_both(text, docs)
    assert got[2] == errors


def test_every_slot_kind_is_covered():
    kinds = set()
    for _name, text, docs in CASES:
        keys, _vals, _err = t_precompute(t_parse(text, "fn.guard"), [t_from_plain(docs[0])])
        kinds.update(k[0] for k in keys)
    assert kinds == {"lit", "plit", "fn", "expr", "pexpr", "pvar"}
    keys = [k[0] for k in precompute_both(FNVAR_RULES, [{}])[1][0]]
    assert set(keys) == {"fn", "expr", "pexpr", "pvar"}


def test_now_and_parse_char_make_no_slot():
    _n, text, docs = _case("now_and_parse_char_stay_host")
    want, got = precompute_both(text, docs)
    assert got[0] == want[0] == []
